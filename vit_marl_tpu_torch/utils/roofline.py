"""The least time an H100 SXM could take for a kernel's work: the bytes it
must move (each input read once, each output written once) over the
memory rate, or its operations over the peak rate for their type,
whichever is longer.  Rates from NVIDIA's data sheet: dense, at the
card's 700 W power limit.  ``chip_smoke.py`` and the tools
(``tools/torch_kernel_bench.py``, ``tools/torch_profile_vit.py``) share
them."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12               # H100 SXM float32 rate outside tensor cores


def attention_cost(B, N, W, H, itemsize, backward):
    """(bytes, float ops) the attention must move and do: qkv (and g) read
    once, the output (dqkv) written once; 4 N^2 D H operations per image
    forward (logits and P v), 10 backward (logits recomputed, dP, dq, dk,
    dv)."""
    rows = B * N
    nbytes = rows * (3 * W + W + (3 * W if backward else 0)) * itemsize
    flops = (10 if backward else 4) * B * N * N * W
    return nbytes, flops


def block_cost(name, B, N, W, hidden, itemsize):
    """(bytes, product operations, attention operations) of
    one fused-block function: row inputs and weights read once, the output
    written once (LayerNorm parameters and biases, float32, too)."""
    rows = B * N
    mm = {"fused_ln_qkv": 3 * W * W,
          "fused_proj_mlp": W * W + 2 * W * hidden,
          "fused_block_full": 4 * W * W + 2 * W * hidden,
          "fused_ln_qkv_attn": 3 * W * W}[name]
    row_io = {"fused_ln_qkv": W + 3 * W, "fused_proj_mlp": 3 * W,
              "fused_block_full": 2 * W, "fused_ln_qkv_attn": 2 * W}[name]
    vecs = {"fused_ln_qkv": 5 * W, "fused_proj_mlp": 4 * W + hidden,
            "fused_block_full": 9 * W + hidden,
            "fused_ln_qkv_attn": 5 * W}[name]
    attn_ops = (4 * B * N * N * W
                if name in ("fused_block_full", "fused_ln_qkv_attn") else 0)
    nbytes = (rows * row_io + mm) * itemsize + 4 * vecs
    return nbytes, 2 * rows * mm, attn_ops


def block_bound(nbytes, mm_ops, attn_ops, dtype):
    """Least time in ms: bytes over the memory rate, or the operations
    (the products and the attention's) over the card's peak rate for the
    inputs' type (bf16: the tensor cores' dense rate; float32: the rate
    outside tensor cores), whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_ops = (mm_ops + attn_ops) / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
