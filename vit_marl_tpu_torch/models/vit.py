"""ViT encoder over the order-book image and the recurrent actor-critic
that fuses it with the flat features.

Port of ``vit_marl_tpu/models/vit.py`` in both of its layouts: flat
``(B*N, W)`` rows (``rows_2d``, the default) or ``(B, N, W)`` tokens
(``rows_2d=False``), with the same parameters.  Its block modes:

- the defaults: the unfused pre-LN ``Block`` with the short-sequence
  attention kernels (``ops/attention_kernel.py``) forward and backward;
  ``attn_kernel=False`` runs the XLA-form attention in plain ops
  (``attention_reference_xla``), ``attn_bwd_kernel=False`` differentiates
  it in place of the backward kernel;
- ``attn_ln_fold``: LN1, QKV and the attention in one kernel
  (``ops/block_kernel.py::fused_ln_qkv_attn``), the rest in plain ops;
- ``fused_block``: LN1+QKV and proj+LN2+MLP as two kernels
  (``fused_ln_qkv``, ``fused_proj_mlp``) around the XLA-form attention;
- ``fused_block_full`` (before ``fused_block``): the whole block in one
  kernel (``fused_block_full``).

The parameters are the same torch modules in every mode, so one
``state_dict`` serves them all.  The book image ``(levels, 3, 2)`` is a
sequence of ``levels`` tokens of 6 features; a float32 linear patch embed
lifts them to width W, a CLS token leads, learned positions are added,
and the CLS row of the last block, after a final LayerNorm, is the
embedding.

Numerics follow flax:

- ``Dense(dtype=compute_dtype)``: input, weight and bias are cast to the
  compute type and the output stays in it;
- LayerNorm with eps 1e-6 computes in float32 and its output is cast to
  the compute type; GELU is the tanh form;
- parameters are float32; the residual stream is in the compute type.

The attention's route is chosen by layout and shape alone, as the JAX
package chooses it (``MHA``, vit.py:187-208): the kernels take flat rows
of N <= 32 tokens; ``(B, N, W)`` tokens of N <= 32 take the XLA-form
attention (``attention_nhd``); past 32 tokens either layout takes
:func:`~vit_marl_tpu_torch.ops.attention_kernel.dot_product_attention`,
counted in its ``.calls``.  The fused modes take both layouts (the rank-3
one as flat rows, as ``_fused_block`` does); past 32 tokens
``fused_block`` runs ``dot_product_attention`` between its kernels, and
``fused_block_full`` and ``attn_ln_fold`` keep their kernels, which take
any number of tokens (their route past 32, ``ops/block_kernel.py``), as
the JAX package's Pallas kernels do.  ``attn_ln_fold`` with
``rows_2d=False`` raises ``ValueError``, as in the JAX package.

``remat`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``, as ``nn.remat(Block)``), so the attention
forward runs twice per block in a PPO update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_marl_tpu_torch.models.rnn import ActorCritic, _dense, _lecun_normal_
from vit_marl_tpu_torch.ops.attention_kernel import (
    MAX_TOKENS,
    attention_reference_xla,
    dot_product_attention,
    short_attention,
)
from vit_marl_tpu_torch.ops.block_kernel import (
    dense,
    fused_block_full,
    fused_ln_qkv,
    fused_ln_qkv_attn,
    fused_proj_mlp,
    gelu,
    layer_norm,
)


@dataclass(frozen=True)
class ViTConfig:
    """Same fields and defaults as the JAX package's ``ViTConfig``."""

    width: int = 192
    depth: int = 12
    heads: int = 3
    mlp_ratio: int = 4
    compute_dtype: str = "bfloat16"   # matmul dtype; params/outputs f32
    remat: bool = True
    fused_block: bool = False
    fused_block_full: bool = False
    rows_2d: bool = True
    attn_kernel: bool = True
    attn_bwd_kernel: bool = True
    attn_env_block: int = 64          # accepted; the CUDA kernels take any B
    attn_ln_fold: bool = False


VIT_PRESETS = {
    "micro": ViTConfig(width=64, depth=2, heads=2),
    "tiny": ViTConfig(width=192, depth=12, heads=3),
    "small": ViTConfig(width=384, depth=12, heads=6),
    "base": ViTConfig(width=768, depth=12, heads=12),
}

def check_ported(cfg: ViTConfig, n_tokens: int) -> None:
    """Raise ``ValueError`` for ``attn_ln_fold`` without ``rows_2d``, as
    the JAX package raises; every other mode runs at any ``n_tokens``."""
    if cfg.attn_ln_fold and not (cfg.fused_block or cfg.fused_block_full) \
            and not cfg.rows_2d:
        raise ValueError("attn_ln_fold requires the rows_2d layout")


def attention(qkv: torch.Tensor, n_tokens: int, heads: int,
              kernel: bool, bwd_kernel: bool) -> torch.Tensor:
    """The attention of flat ``(B*N, 3W)`` qkv rows on the route the JAX
    package's ``MHA`` takes (vit.py:187-208): the kernels where
    ``kernel`` (flat rows, ``attn_kernel``) and N <= 32; else the
    XLA-form attention for N <= 32; else ``dot_product_attention``."""
    if n_tokens > MAX_TOKENS:
        return dot_product_attention(qkv, n_tokens, heads)
    if kernel:
        return short_attention(qkv, n_tokens, heads, bwd_kernel=bwd_kernel)
    return attention_reference_xla(qkv, n_tokens, heads)


class Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: input, weight and bias cast to the compute
    type, output in it; lecun-normal weight, zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        with torch.no_grad():
            _lecun_normal_(self.weight)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: float32 statistics and output."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class MHA(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.width, 3 * cfg.width, dtype)
        self.proj = Dense(cfg.width, cfg.width, dtype)

    def forward(self, x: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """``(B*N, W)`` rows or ``(B, N, W)`` tokens -> the same shape;
        ``qkv`` lanes are ``[q | k | v]`` with heads contiguous, the
        kernel's layout.  Only flat rows take the kernels, as only rank-2
        input does in the JAX package."""
        c = self.cfg
        qkv = self.qkv(x)
        out = attention(qkv.reshape(-1, qkv.shape[-1]), n_tokens, c.heads,
                        c.attn_kernel and x.dim() == 2, c.attn_bwd_kernel)
        return self.proj(out.reshape(x.shape))


def _cls_rows(x: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The CLS token (token 0) of each image, ``(B, W)``, from flat rows
    or ``(B, N, W)`` tokens."""
    return (x.reshape(-1, n_tokens, x.shape[-1]) if x.dim() == 2 else x)[:, 0]


class Block(nn.Module):
    """Pre-LN transformer block on flat rows, in the mode ``cfg`` names."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        W = cfg.width
        self.cfg = cfg
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(W, eps=1e-6)
        self.attn = MHA(cfg, dtype)
        self.ln2 = nn.LayerNorm(W, eps=1e-6)
        self.mlp1 = Dense(W, W * cfg.mlp_ratio, dtype)
        self.mlp2 = Dense(W * cfg.mlp_ratio, W, dtype)

    def forward(self, x: torch.Tensor, n_tokens: int,
                cls_only: bool = False) -> torch.Tensor:
        """``cls_only``: LN2 and the MLP on the CLS rows only, returning
        ``(B, W)``; nothing else after the last block's attention reaches
        the output.  The fused-block modes ignore it and keep every row."""
        c = self.cfg
        if c.fused_block or c.fused_block_full:
            return self._fused_block(x, n_tokens)
        if c.attn_ln_fold:
            return self._attn_ln_fold_block(x, n_tokens, cls_only)
        x = x + self.attn(_layer_norm(self.ln1, x).to(self.dtype), n_tokens)
        if cls_only:
            x = _cls_rows(x, n_tokens)
        h = _layer_norm(self.ln2, x).to(self.dtype)
        h = self.mlp2(F.gelu(self.mlp1(h), approximate="tanh"))
        return x + h

    def _fused_params(self):
        """The fused kernels' operands: LayerNorm parameters and biases in
        float32, weights in the compute type."""
        dt = self.dtype
        a = self.attn
        return (self.ln1.weight, self.ln1.bias, a.qkv.weight.to(dt),
                a.qkv.bias, a.proj.weight.to(dt), a.proj.bias,
                self.ln2.weight, self.ln2.bias, self.mlp1.weight.to(dt),
                self.mlp1.bias, self.mlp2.weight.to(dt), self.mlp2.bias)

    def _fused_block(self, x: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """``fused_block_full``: one kernel.  ``fused_block``: LN1+QKV and
        proj+LN2+MLP kernels around the XLA-form attention (past 32
        tokens ``dot_product_attention``).  ``(B, N, W)`` tokens run as
        flat rows."""
        p = self._fused_params()
        shape = x.shape
        x = x.reshape(-1, shape[-1]).to(self.dtype)
        if self.cfg.fused_block_full:
            out = fused_block_full(x, *p, n_tokens, self.cfg.heads)
        else:
            attn = attention(fused_ln_qkv(x, *p[:4]), n_tokens,
                             self.cfg.heads, False, False)
            out = fused_proj_mlp(attn, x, *p[4:])
        return out.reshape(shape)

    def _attn_ln_fold_block(self, x: torch.Tensor, n_tokens: int,
                            cls_only: bool) -> torch.Tensor:
        """LN1+QKV+attention in one kernel; the projection, residuals, LN2
        and MLP in plain ops with the kernel tail's rounding, so the last
        block can still keep the CLS rows only."""
        g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2, bm2 = \
            self._fused_params()
        x = x.to(self.dtype)
        attn = fused_ln_qkv_attn(x, g1, b1, wqkv, bqkv, n_tokens,
                                 self.cfg.heads,
                                 bwd_kernel=self.cfg.attn_bwd_kernel)
        x1 = x + dense(attn, wp, bp)
        if cls_only:
            x1 = _cls_rows(x1, n_tokens)
        h = layer_norm(x1, g2, b2).to(self.dtype)
        return x1 + dense(gelu(dense(h, w1, bm1)), w2, bm2)


class ViTEncoder(nn.Module):
    """Book image ``(..., levels, 3, 2)`` -> ``(..., width)`` float32."""

    def __init__(self, cfg: ViTConfig, levels: int):
        super().__init__()
        check_ported(cfg, levels + 1)
        # The float32 products around the bf16 blocks (patch embed, fusion,
        # GRU, heads) run in full float32 as in the JAX package, and bf16
        # products accumulate in float32: no TF32, no reduced-precision
        # bf16 reductions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        W = cfg.width
        self.patch_embed = Dense(6, W)
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, levels + 1, W))
        self.cls = nn.Parameter(0.02 * torch.randn(1, 1, W))
        self.blocks = nn.ModuleList(Block(cfg, self.dtype)
                                    for _ in range(cfg.depth))
        self.ln_f = nn.LayerNorm(W, eps=1e-6)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        lead = image.shape[:-3]
        levels = image.shape[-3]
        W, N = self.cfg.width, levels + 1
        # (levels, 3, 2) -> (levels, 6) row-major, as image.reshape in JAX
        x = image.reshape(-1, levels, image.shape[-2] * image.shape[-1])
        x = self.patch_embed(x.float()).to(self.dtype)
        cls = self.cls.expand(x.shape[0], 1, W).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        if self.cfg.rows_2d:
            x = x.reshape(-1, W)
        remat = self.cfg.remat and torch.is_grad_enabled()
        # the last block runs LN2 and the MLP on the CLS rows only, except
        # in the fused-block modes, whose kernels take whole images
        cls_short = not (self.cfg.fused_block or self.cfg.fused_block_full)
        for i, block in enumerate(self.blocks):
            last = cls_short and i == len(self.blocks) - 1
            if remat:
                x = checkpoint(block, x, N, last, use_reentrant=False)
            else:
                x = block(x, N, last)
        if not cls_short:
            x = _cls_rows(x, N)
        return _layer_norm(self.ln_f, x).reshape(lead + (W,))


class GateFusion(nn.Module):
    """Gated fusion of the vision and flat embeddings (float32)."""

    def __init__(self, vision_dim: int, flat_dim: int, out_dim: int):
        super().__init__()
        self.v_proj = Dense(vision_dim, out_dim)
        self.f_proj = Dense(flat_dim, out_dim)
        self.gate = Dense(2 * out_dim, out_dim)

    def forward(self, vision: torch.Tensor, flat: torch.Tensor
                ) -> torch.Tensor:
        v = self.v_proj(vision)
        f = self.f_proj(flat)
        gate = torch.sigmoid(self.gate(torch.cat([v, f], dim=-1)))
        return gate * v + (1 - gate) * f


class VisionActorCritic(ActorCritic):
    """``{"obs", "vision_obs"}`` dicts of ``(T, B, ...)`` and ``(T, B)``
    dones -> (hidden, pi, value): the vision encoder's embedding of the
    book image and a Dense embedding of the flat features, gated fusion,
    GRU, then the heads of ``ActorCriticRNN`` (orthogonal inits, same
    gains; ``log_std`` for a continuous head).  The encoder is the
    submodule named ``encoder_name``, whose output is ``vision_dim``
    wide."""

    def __init__(self, encoder_name: str, encoder: nn.Module,
                 vision_dim: int, obs_dim: int, action_dim: int,
                 fc_dim: int, hidden_size: int,
                 action_low: Optional[torch.Tensor],
                 action_high: Optional[torch.Tensor]):
        super().__init__()
        self.encoder_name = encoder_name
        self.add_module(encoder_name, encoder)
        self.flat_embed = _dense(obs_dim, fc_dim, math.sqrt(2))
        self.fusion = GateFusion(vision_dim, fc_dim, fc_dim)
        self._init_heads(fc_dim, hidden_size, action_dim, action_low,
                         action_high)

    def forward(self, hidden: torch.Tensor, obs, dones: torch.Tensor):
        vision = getattr(self, self.encoder_name)(obs["vision_obs"])
        flat = torch.relu(self.flat_embed(obs["obs"]))
        emb = torch.relu(self.fusion(vision, flat))
        return self._recurrent_heads(hidden, emb, dones)


class ViTActorCriticRNN(VisionActorCritic):
    """The vision actor-critic on the ViT encoder (``network: vit_gru``)."""

    def __init__(self, obs_dim: int, levels: int, action_dim: int,
                 vit: ViTConfig, fc_dim: int = 64, hidden_size: int = 64,
                 action_low: Optional[torch.Tensor] = None,
                 action_high: Optional[torch.Tensor] = None):
        super().__init__("vit", ViTEncoder(vit, levels), vit.width, obs_dim,
                         action_dim, fc_dim, hidden_size, action_low,
                         action_high)
