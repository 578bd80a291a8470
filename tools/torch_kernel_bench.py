"""Kernel A/Bs: each fused-block and attention kernel of the port against
the port's unfused PyTorch sequence of the same function.

Counterpart of ``tools/kernel_bench.py``, at its shapes (the ViT-Small
bench: 8,192 envs x 11 tokens, W=384, H=6, bf16) and flags, with
``--device`` in place of ``--cpu``.  Rows:

- ``ln_qkv``, ``proj_mlp``, ``full_block``, ``ln_qkv_attn``: the CUDA
  kernels ``fused_ln_qkv``, ``fused_proj_mlp``, ``fused_block_full`` and
  ``fused_ln_qkv_attn`` (``ops/block_kernel.py``; the JAX tool leaves
  the last out) against LayerNorm in float32, ``F.linear`` with bf16
  products, tanh GELU and ``scaled_dot_product_attention``
  (``selfcheck.py::unfused_call``);
- ``attention``: the short-attention forward kernel
  (``ops/attention_kernel.py``) against ``scaled_dot_product_attention``
  on the heads laid out for it.

Each row gives the unfused sequence's ms, the kernel's, their ratio and
the kernel's bound (``utils/roofline.py::block_bound``: inputs read and
outputs written once at 3.35 TB/s, or every operation at 989 TFLOP/s);
the last line names the card and its power limit.  Times: CUDA events,
medians of batches with the L2 flushed between them
(``utils/profiling.py::median_ms``).  Inputs come from a numpy seed, as
``kernel_bench.py``'s from a JAX key.  A shape a kernel does not take is
skipped with its reason.  With ``--device cpu`` both sides run plain
PyTorch (the wrappers' plain versions on CPU tensors): a smoke test at
tiny sizes whose times say nothing of the card.

Usage: python tools/torch_kernel_bench.py [--envs 8192] [--width 384]
       [--heads 6] [--reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vit_marl_tpu_torch.ops import attention_kernel as attn  # noqa: E402
from vit_marl_tpu_torch.ops import block_kernel as blk  # noqa: E402
from vit_marl_tpu_torch.selfcheck import (  # noqa: E402
    block_calls,
    unfused_attention,
    unfused_call,
)
from vit_marl_tpu_torch.utils.profiling import (  # noqa: E402
    device_label,
    median_ms,
)
from vit_marl_tpu_torch.utils.roofline import (  # noqa: E402
    attention_cost,
    block_bound,
    block_cost,
)

N_TOKENS = 11
MLP_RATIO = 4
FUSED = {"ln_qkv": "fused_ln_qkv", "proj_mlp": "fused_proj_mlp",
         "full_block": "fused_block_full", "ln_qkv_attn": "fused_ln_qkv_attn"}
ROWS = ("ln_qkv", "proj_mlp", "attention", "full_block", "ln_qkv_attn")


def inputs(rows: int, W: int, device, seed: int = 0):
    """Block rows, qkv and attention rows in bf16 and a block's
    parameters (LayerNorms and biases float32, weights ``(out, in)`` in
    bf16), from a numpy seed at ``kernel_bench.py:66-84``'s scales."""
    rng = np.random.default_rng(seed)
    hidden = MLP_RATIO * W

    def t(*shape, scale=1.0, loc=0.0, dtype=torch.float32):
        v = loc + scale * rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(v).to(device=device, dtype=dtype)

    bf = torch.bfloat16
    p = dict(g1=t(W, scale=0.1, loc=1.0), b1=t(W, scale=0.1),
             wqkv=t(3 * W, W, scale=0.05, dtype=bf), bqkv=t(3 * W, scale=0.1),
             wp=t(W, W, scale=0.05, dtype=bf), bp=t(W, scale=0.1),
             g2=t(W, scale=0.1, loc=1.0), b2=t(W, scale=0.1),
             w1=t(hidden, W, scale=0.05, dtype=bf), bm1=t(hidden, scale=0.1),
             w2=t(W, hidden, scale=0.05, dtype=bf), bm2=t(W, scale=0.1))
    x = t(rows, W, scale=0.5, dtype=bf)
    qkv = t(rows, 3 * W, scale=0.5, dtype=bf)
    a = t(rows, W, scale=0.5, dtype=bf)
    return x, qkv, a, p


def why_skipped(row: str, W: int, heads: int):
    """Why the kernel of ``row`` cannot take width W and ``heads`` heads,
    or None."""
    D = W // heads
    if W % heads or D % 8 or D > 128:
        if row in ("attention", "full_block", "ln_qkv_attn"):
            return f"D={W}/{heads}: the attention takes D = 8k <= 128"
    if row != "attention":
        hidden = MLP_RATIO * W
        if W % 64 or not blk.fits_kernel(FUSED[row], W, hidden):
            return (f"W={W}, hidden {hidden}: the kernel takes W = 64k <= "
                    f"{blk.MAX_WIDTH}, hidden <= {blk.MAX_HIDDEN}")
    return None


def bench(envs: int, W: int, heads: int, reps: int, device):
    """One dict a kernel row: unfused and kernel ms, ratio, bound; prints
    each skipped row's reason."""
    N, hidden = N_TOKENS, MLP_RATIO * W
    x, qkv, a, p = inputs(envs * N, W, device)
    out = []
    for row in ROWS:
        why = why_skipped(row, W, heads)
        if why:
            print(f"skip {row}: {why}", flush=True)
            continue
        if row == "attention":
            kern = lambda: attn.short_attention(qkv, N, heads)  # noqa: E731
            seq = lambda: unfused_attention(qkv, N, heads)  # noqa: E731
            nbytes, flops = attention_cost(envs, N, W, heads, 2, False)
            bnd, by = block_bound(nbytes, 0, flops, "bfloat16")
        else:
            name = FUSED[row]
            kern = block_calls(blk, name, x, a, p, N, heads)[0]
            seq = unfused_call(name, x, a, p, N, heads)
            bnd, by = block_bound(*block_cost(name, envs, N, W, hidden, 2),
                                  "bfloat16")
        with torch.no_grad():
            seq_ms = median_ms(seq, device, reps)
            k_ms = median_ms(kern, device, reps)
        out.append(dict(kernel=row, unfused_ms=seq_ms, kernel_ms=k_ms,
                        ratio=seq_ms / k_ms, bound_ms=bnd, bound_by=by))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain versions; smoke)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device (use --device cpu for a "
              "smoke run)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bench(args.envs, args.width, args.heads, args.reps, device)
    N = N_TOKENS
    print(f"\n# kernel A/Bs @ envs={args.envs} N={N} W={args.width} "
          f"H={args.heads} (rows={args.envs * N}, bf16)")
    print(f"{'kernel':12s} {'unfused ms':>11s} {'kernel ms':>10s} "
          f"{'ratio':>7s} {'bound ms':>9s}")
    for r in rows:
        print(f"{r['kernel']:12s} {r['unfused_ms']:11.4f} "
              f"{r['kernel_ms']:10.4f} {r['ratio']:6.2f}x "
              f"{r['bound_ms']:9.4f} ({r['bound_by']})")
    print(device_label(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
