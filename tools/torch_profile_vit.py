"""Stage decomposition of the port's ViT forward at the bench's shapes.

Counterpart of ``tools/profile_vit.py``: times the stages of the ViT-Small
forward (``vit_marl_tpu_torch/models/vit.py``) at B envs of 11 tokens so
a policy step can be split into attention, MLP and LayerNorm and set
against the card's bf16 roofline:

- ``full_policy_fwd``: the vision actor-critic (``ViTActorCriticRNN``,
  a GRU and a continuous head) on one step of B envs;
- ``vit_encoder`` (the attention kernel off, the XLA-form attention) and
  ``vit_encoder_attnkernel``, and the encoder in each block mode:
  ``_fusedblock``, ``_fusedblockfull``, ``_lnfold`` and ``_rank3``
  (``(B, N, W)`` tokens);
- forward and backward (the gradient of every parameter):
  ``_fwdbwd_bwdkernel`` (the attention backward kernel),
  ``_fwdbwd_xlabwd`` (the XLA-form attention differentiated) and
  ``_fwdbwd_lnfold``;
- ``attn_stack_x12`` (LayerNorm, attention and residual, ``depth``
  times), ``mlp_stack_x12`` (LayerNorm, MLP and residual) and
  ``ln_stack_x24`` (``2 depth`` LayerNorms).

Every stage but the fused modes' own runs without ``remat``, and the
forward stages under ``torch.no_grad``, as in the JAX tool.  The
roofline counts the JAX tool's operations, ``depth * 24 * N * W^2`` an
env (QKV, projection and MLP products), over the card's dense bf16 peak
(``utils/roofline.py``, 989 TFLOP/s for an H100 SXM at 700 W).  A stage
whose kernel cannot take the shape prints why it is skipped.

On the card (the default) the stages run the CUDA kernels, timed by
``utils/profiling.py::median_ms`` (CUDA events, medians of batches, the
L2 flushed between them); with ``--device cpu`` the plain versions, as a
smoke test at tiny sizes whose times say nothing of the card.

Usage: python tools/torch_profile_vit.py [--envs 8192] [--preset small]
       [--reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vit_marl_tpu_torch.utils.profiling import (  # noqa: E402
    device_label,
    median_ms,
)

N_TOKENS = 11                   # 10 book levels and the CLS token


def _encoder(cfg, base, levels, device, **modes):
    """An encoder in block mode ``modes`` with ``base``'s weights (every
    mode has the same parameters)."""
    from vit_marl_tpu_torch.models.vit import ViTEncoder

    enc = ViTEncoder(dataclasses.replace(cfg, **modes), levels).to(device)
    enc.load_state_dict(base.state_dict())
    return enc


def _grad_norm(enc, img):
    """Forward and backward of ``sum(enc(img)^2)`` to every parameter;
    the gradients' squared norm."""
    params = list(enc.parameters())

    def f():
        with torch.enable_grad():
            loss = enc(img).float().pow(2).sum()
            grads = torch.autograd.grad(loss, params)
        return sum(g.float().pow(2).sum() for g in grads)
    return f


def _why_skipped(name, cfg, hidden):
    """Why a stage's kernel cannot take the preset's shape, or None."""
    from vit_marl_tpu_torch.ops import block_kernel as blk

    D = cfg.width // cfg.heads
    if name == "attention" and (D % 8 or D > 128):
        return f"head width {D}: the attention kernel takes D = 8k <= 128"
    if name in blk.KINDS and not blk.fits_kernel(name, cfg.width, hidden):
        return (f"width {cfg.width} / hidden {hidden}: past the kernel's "
                f"{blk.MAX_WIDTH} / {blk.MAX_HIDDEN} (the composed route)")
    return None


def profile(envs: int, preset: str, reps: int, device: torch.device):
    """({stage: ms}, the roofline line, the roofline's ms) of the ViT
    forward at ``envs`` envs; prints each skipped stage's reason."""
    from torch import nn
    from vit_marl_tpu_torch.models.rnn import ScannedGRU
    from vit_marl_tpu_torch.models.vit import (MHA, VIT_PRESETS, Dense,
                                               ViTActorCriticRNN, ViTEncoder,
                                               _layer_norm)

    B, N, levels = envs, N_TOKENS, N_TOKENS - 1
    cfg = dataclasses.replace(VIT_PRESETS[preset], remat=False,
                              attn_kernel=False)
    W, hidden = cfg.width, cfg.width * cfg.mlp_ratio
    dt = getattr(torch, cfg.compute_dtype)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    results = {}

    def stage(name, make, kernel=None):
        """Time the call ``make()`` returns, unless ``kernel`` cannot take
        the shape."""
        why = _why_skipped(kernel, cfg, hidden) if kernel else None
        if why:
            print(f"skip {name}: {why}", flush=True)
        else:
            results[name] = median_ms(make(), device, reps)

    # ---- the full policy forward (the bench's configuration) ----
    net = ViTActorCriticRNN(28, levels, 3, cfg, fc_dim=64, hidden_size=64,
                            action_low=torch.tensor([-1.0, 0.0, 0.0]),
                            action_high=torch.tensor([3.0, 1.0, 1.0])
                            ).to(device)
    obs = {"obs": rand(1, B, 28), "vision_obs": rand(1, B, levels, 3, 2)}
    dones = torch.zeros((1, B), dtype=torch.bool, device=device)
    h0 = ScannedGRU.initialize_carry(B, 64, device)
    img = obs["vision_obs"][0]

    def forward(e):
        return lambda: e(img)

    with torch.no_grad():
        stage("full_policy_fwd",
              lambda: lambda: net(h0, obs, dones)[1].mode())
        # ---- the encoder alone, in each mode ----
        enc = ViTEncoder(cfg, levels).to(device)
        stage("vit_encoder", lambda: forward(enc))
        for name, kernel, modes in (
                ("vit_encoder_attnkernel", "attention",
                 dict(attn_kernel=True)),
                ("vit_encoder_fusedblock", "fused_proj_mlp",
                 dict(fused_block=True)),
                ("vit_encoder_fusedblockfull", "fused_block_full",
                 dict(fused_block_full=True)),
                ("vit_encoder_lnfold", "fused_ln_qkv_attn",
                 dict(attn_ln_fold=True)),
                ("vit_encoder_rank3", None, dict(rows_2d=False))):
            stage(name, lambda modes=modes: forward(
                _encoder(cfg, enc, levels, device, **modes)), kernel)
    # ---- forward and backward ----
    for name, kernel, modes in (
            ("vit_encoder_fwdbwd_bwdkernel", "attention",
             dict(attn_kernel=True, attn_bwd_kernel=True)),
            ("vit_encoder_fwdbwd_xlabwd", "attention",
             dict(attn_kernel=True, attn_bwd_kernel=False)),
            ("vit_encoder_fwdbwd_lnfold", "fused_ln_qkv_attn",
             dict(attn_ln_fold=True))):
        stage(name, lambda modes=modes: _grad_norm(
            _encoder(cfg, enc, levels, device, **modes), img), kernel)

    # ---- sub-stacks on (B, N, W) float32 tokens ----
    class AttnStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = nn.ModuleList(nn.LayerNorm(W, eps=1e-6)
                                    for _ in range(cfg.depth))
            self.attn = nn.ModuleList(MHA(cfg, dt) for _ in range(cfg.depth))

        def forward(self, x):
            for ln, attn in zip(self.ln, self.attn):
                x = x + attn(_layer_norm(ln, x).to(dt), N)
            return x.float()

    class MLPStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = nn.ModuleList(nn.LayerNorm(W, eps=1e-6)
                                    for _ in range(cfg.depth))
            self.fc1 = nn.ModuleList(Dense(W, hidden, dt)
                                     for _ in range(cfg.depth))
            self.fc2 = nn.ModuleList(Dense(hidden, W, dt)
                                     for _ in range(cfg.depth))

        def forward(self, x):
            for ln, fc1, fc2 in zip(self.ln, self.fc1, self.fc2):
                h = fc1(_layer_norm(ln, x).to(dt))
                x = x + fc2(torch.nn.functional.gelu(h, approximate="tanh"))
            return x.float()

    class LNStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = nn.ModuleList(nn.LayerNorm(W, eps=1e-6)
                                    for _ in range(2 * cfg.depth))

        def forward(self, x):
            for ln in self.ln:
                x = _layer_norm(ln, x)
            return x

    tokens = rand(B, N, W)
    with torch.no_grad():
        for name, mod in (("attn_stack_x12", AttnStack()),
                          ("mlp_stack_x12", MLPStack()),
                          ("ln_stack_x24", LNStack())):
            mod = mod.to(device)
            stage(name, lambda m=mod: lambda: m(tokens))

    from vit_marl_tpu_torch.utils.roofline import BF16_FLOPS

    # per block: qkv 2*3*N*W^2 + proj 2*N*W^2 + mlp 2*2*N*W*4W
    flops_env = cfg.depth * (6 + 2 + 16) * N * W * W
    total_tflop = flops_env * B / 1e12
    peak = BF16_FLOPS / 1e12
    roof_ms = total_tflop / peak * 1e3
    roof = (f"# {preset} B={B} N={N} W={W}: {flops_env / 1e6:.0f} MFLOP/env, "
            f"{total_tflop:.3f} TFLOP/fwd, bf16 roofline {roof_ms:.3f} ms "
            f"(peak {peak:.0f} TFLOP/s)")
    return results, roof, roof_ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--preset", default="small")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (plain versions; smoke)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_profile_vit: no CUDA device (use --device cpu for a "
              "smoke run)", file=sys.stderr)
        return 2
    results, roof, roof_ms = profile(args.envs, args.preset, args.reps,
                                        device)
    print(f"\n{roof}")
    for k, v in results.items():
        share = (f"   roofline share {roof_ms / v * 100:.1f}%"
                 if k in ("full_policy_fwd", "vit_encoder") else "")
        print(f"{k:30s} {v:10.4f} ms{share}")
    print(device_label(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
