"""Every CUDA kernel of the port against its plain version on the card.

Counterpart of ``bench.py::kernel_selfcheck`` (which checks the compiled
Pallas kernels): ``kernel_selfcheck(env, n_envs, gen)`` runs the eight
kernels at the bench's shapes and holds each against its plain PyTorch
version:

- the book scan in aggregate mode (kernel 1) in all four cancel modes and
  in records mode (kernel 2, 16 fills a message), on the stream the
  world's own message builder makes from a reset of the bench's envs and
  random actions: bit-equal;
- the short attention forward and backward (kernels 3 and 4) at
  ViT-Small's shapes (N=11, H=6, D=64) on the bench's batch of images in
  bf16 and on 1,000 images in float32: :data:`ATT_TOL`;
- the four fused-block kernels (5, 6a, 6b, 7) at ViT-Small's widths on
  the same batches: :func:`block_tol`.

The tolerances are those of ``chip_smoke.py``, which imports them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ATT_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=8e-3, atol=1e-3)}
F32_BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
# ViT-Small: tokens, width, heads, MLP ratio
N_TOKENS, WIDTH, HEADS, MLP_RATIO = 11, 384, 6, 4


def block_tol(name: str, want: torch.Tensor) -> dict:
    """float32: rtol 2e-5, atol 2e-5.  bf16: two ulps of the element (rtol
    1.6e-2), or ulps of the largest magnitude of the output (atol): the
    fused functions round a chain of intermediates (qkv, attention, x1,
    the MLP's sum), and a one-ulp flip in one of them, from another order
    of summation, reaches the output; where the output cancels to near 0
    (``x1 + mlp``, or ``P v`` over values of both signs) the error is an
    ulp of the intermediates, at the scale of the rows.  Two ulps, and
    three where the output ends in ``x1 + mlp`` (x1, the MLP's sum and
    their sum each round once)."""
    if want.element_size() == 4:
        return dict(F32_BLOCK_TOL)
    ulps = 3 if name in ("fused_proj_mlp", "fused_block_full") else 2
    m = float(want.float().abs().max())
    return dict(rtol=1.6e-2, atol=ulps * 2.0 ** (math.floor(math.log2(m)) - 7)
                if m else 1e-2)


def block_params(gen: torch.Generator, dtype: torch.dtype, width: int,
                 hidden: int) -> Dict[str, torch.Tensor]:
    """A block's parameters on ``gen``'s device: LayerNorms and biases
    float32, weights ``(out, in)`` in ``dtype``."""
    dev = gen.device

    def rand(*shape, scale=1.0, loc=0.0, dt=torch.float32):
        return (loc + scale * torch.randn(shape, generator=gen,
                                          device=dev)).to(dt)

    W = width
    return dict(
        g1=rand(W, scale=0.1, loc=1.0), b1=rand(W, scale=0.1),
        wqkv=rand(3 * W, W, scale=W ** -0.5, dt=dtype),
        bqkv=rand(3 * W, scale=0.1),
        wp=rand(W, W, scale=W ** -0.5, dt=dtype), bp=rand(W, scale=0.1),
        g2=rand(W, scale=0.1, loc=1.0), b2=rand(W, scale=0.1),
        w1=rand(hidden, W, scale=W ** -0.5, dt=dtype),
        bm1=rand(hidden, scale=0.1),
        w2=rand(W, hidden, scale=hidden ** -0.5, dt=dtype),
        bm2=rand(W, scale=0.1))


def block_calls(blk, name: str, x, a, p, n_tokens: int, heads: int):
    """(wrapper, plain version) of fused-block function ``name`` on rows
    ``x`` (and attention rows ``a`` for proj+MLP)."""
    head = (x, p["g1"], p["b1"], p["wqkv"], p["bqkv"])
    rest = tuple(p[k] for k in ("wp", "bp", "g2", "b2", "w1", "bm1", "w2",
                                "bm2"))
    if name == "fused_ln_qkv":
        return (lambda: blk.fused_ln_qkv(*head),
                lambda: blk.ln_qkv_reference(*head))
    if name == "fused_proj_mlp":
        return (lambda: blk.fused_proj_mlp(a, x, *rest),
                lambda: blk.proj_mlp_reference(a, x, *rest))
    if name == "fused_block_full":
        return (lambda: blk.fused_block_full(*head, *rest, n_tokens, heads),
                lambda: blk.full_block_reference(*head, *rest, n_tokens,
                                                 heads))
    return (lambda: blk.fused_ln_qkv_attn(*head, n_tokens, heads),
            lambda: blk.ln_qkv_attn_reference(*head, n_tokens, heads))


def unfused_attention(qkv: torch.Tensor, n_tokens: int, heads: int):
    """Attention over flat ``(B*N, 3W)`` qkv rows as one library call,
    ``scaled_dot_product_attention``, on the heads laid out for it."""
    W = qkv.shape[1] // 3
    q, k, v = qkv.view(-1, n_tokens, 3, heads, W // heads).permute(
        2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return o.transpose(1, 2).reshape(-1, W)


def unfused_call(name: str, x, a, p, n_tokens: int, heads: int):
    """The unfused PyTorch sequence of fused-block function ``name`` (the
    yardstick of the kernels' times; the port never runs it): LayerNorm
    in float32, ``F.linear`` in the rows' type, tanh GELU and
    :func:`unfused_attention`, on rows ``x`` (and attention rows ``a``
    for proj+MLP)."""
    F = torch.nn.functional
    W = x.shape[1]
    dt = x.dtype

    def ln(t, g, b):
        return F.layer_norm(t.float(), (W,), g, b, 1e-6).to(dt)

    def tail(att, res):
        x1 = res + F.linear(att, p["wp"], p["bp"].to(dt))
        h = F.gelu(F.linear(ln(x1, p["g2"], p["b2"]), p["w1"],
                            p["bm1"].to(dt)), approximate="tanh")
        return x1 + F.linear(h, p["w2"], p["bm2"].to(dt))

    def qkv_seq(t):
        return F.linear(ln(t, p["g1"], p["b1"]), p["wqkv"], p["bqkv"].to(dt))

    if name == "fused_ln_qkv":
        return lambda: qkv_seq(x)
    if name == "fused_proj_mlp":
        return lambda: tail(a, x)
    if name == "fused_block_full":
        return lambda: tail(unfused_attention(qkv_seq(x), n_tokens, heads),
                            x)
    return lambda: unfused_attention(qkv_seq(x), n_tokens, heads)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _close(a, b, tol) -> bool:
    return bool(torch.isclose(a.float(), b.float(), **tol).all())


def _book_checks(env, E: int, gen) -> Dict[str, Tuple[bool, float]]:
    """Kernels 1 and 2 on the world's message stream of E envs,
    bit-equal."""
    import dataclasses

    from vit_marl_tpu_torch.env import spaces
    from vit_marl_tpu_torch.ops import book_kernel as bkern

    params = env.default_params
    _, state = env.reset(env.draw_reset(E, gen), params)
    actions = [torch.randint(0, sp.n, (E,), generator=gen, device=env.device)
               if isinstance(sp, spaces.Discrete) else
               sp.low.to(env.device) + (sp.high - sp.low).to(env.device)
               * torch.rand((E,) + tuple(sp.shape), generator=gen,
                            device=env.device)
               for sp in env.action_spaces]
    draws = env.draw_step(E, gen)
    msgs, _ = env._build_messages(state, env._actions(actions), params,
                                  draws.shuffle)
    book = state.world.books
    prev = torch.stack([state.world.best_asks[:, -1, 0],
                        state.world.best_bids[:, -1, 0]], 1)
    tids = torch.cat([p.trader_id for p in params.agents])
    u = torch.rand((msgs.shape[1], E), generator=gen, device=env.device)
    out = {}

    def equal(got, want):
        got, want = _flat(got), _flat(want)
        return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                   for a, b in zip(got, want))

    worst = 0
    for mode in range(4):
        cfg = dataclasses.replace(env.wcfg, cancel_mode=mode)
        worst = max(worst, equal(
            bkern.process_step_aggs(cfg, msgs, book, tids, prev,
                                    cfg.tick_size, u),
            bkern.process_step_aggs_reference(cfg, msgs, book, tids, prev,
                                              cfg.tick_size, u)))
    out["book_scan_aggs"] = (worst == 0, float(worst))
    err = equal(bkern.process_step_records(env.wcfg, msgs, book, prev, 16, u),
                bkern.process_step_records_reference(env.wcfg, msgs, book,
                                                     prev, 16, u))
    out["book_scan_records"] = (err == 0, float(err))
    return out


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "data") and isinstance(tree.data, torch.Tensor):
        return [tree.data]
    return [t for x in tree for t in _flat(x)]


def _float_checks(gen, B: int) -> Dict[str, Tuple[bool, float]]:
    """Kernels 3-7 at ViT-Small's shapes on B images (bf16) and on 1,000
    (float32)."""
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import block_kernel as blk

    dev = gen.device
    N, W, H = N_TOKENS, WIDTH, HEADS
    res = {k: [True, 0.0] for k in (
        "short_attention_fwd", "short_attention_bwd", "fused_ln_qkv",
        "fused_proj_mlp", "fused_block_full", "fused_ln_qkv_attn")}

    def note(name, got, want, tol):
        r = res[name]
        r[0] &= _close(got, want, tol)
        r[1] = max(r[1], _max_err(got, want))

    for images, dtype in ((B, torch.bfloat16), (1000, torch.float32)):
        tol = ATT_TOL[str(dtype)[6:]]
        x = torch.randn((images * N, 3 * W), generator=gen,
                        device=dev).to(dtype).requires_grad_(True)
        g = torch.randn((images * N, W), generator=gen, device=dev).to(dtype)
        out = attn.short_attention(x, N, H)
        (dx,) = torch.autograd.grad(out, x, g)
        x = x.detach()
        note("short_attention_fwd", out.detach(),
             attn.short_attention_reference(x, N, H), tol)
        note("short_attention_bwd", dx,
             attn.short_attention_bwd_reference(x, g, N, H), tol)
        p = block_params(gen, dtype, W, MLP_RATIO * W)
        rows = torch.randn((images * N, W), generator=gen, device=dev).to(
            dtype)
        arows = torch.randn((images * N, W), generator=gen,
                            device=dev).to(dtype)
        with torch.no_grad():
            for name in ("fused_ln_qkv", "fused_proj_mlp", "fused_block_full",
                         "fused_ln_qkv_attn"):
                kern, plain = block_calls(blk, name, rows, arows, p, N, H)
                want = plain()
                note(name, kern(), want, block_tol(name, want))
    return {k: (bool(v[0]), float(v[1])) for k, v in res.items()}


def kernel_selfcheck(env, n_envs: int, gen: torch.Generator
                     ) -> Dict[str, Tuple[bool, float]]:
    """``{kernel: (ok, max abs err)}`` for the eight kernels; ``env`` is
    the bench's world on the card, ``n_envs`` its batch (of envs, and of
    images for kernels 3-7)."""
    if env.device.type != "cuda":
        raise RuntimeError("the kernel selfcheck needs a CUDA device")
    out = _book_checks(env, n_envs, gen)
    out.update(_float_checks(gen, n_envs))
    torch.cuda.synchronize(env.device)
    return out
