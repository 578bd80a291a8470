"""Fused pre-LN transformer-block functions for the ViT's fused modes.

Replaces the TPU kernels of ``vit_marl_tpu/ops/block_kernel.py``:

- :func:`fused_ln_qkv` (``fused_ln_qkv``): ``LN1(x) Wqkv + b``;
- :func:`fused_proj_mlp` (``fused_proj_mlp``): ``x1 = x + (a Wp + bp)``,
  ``out = x1 + (gelu(LN2(x1) W1 + b1) W2 + b2)``;
- :func:`fused_block_full` (``fused_block_full``): the whole block, the
  attention between the two;
- :func:`fused_ln_qkv_attn` (``fused_ln_qkv_attn``): the attention of
  ``LN1(x) Wqkv + b``.

Rows are flat ``(B*N, W)`` token rows in the compute type (float32 or
bf16), images N consecutive rows; weights are in the compute type in
torch's ``Linear`` layout ``(out, in)``; LayerNorm parameters and biases
may be float32.  Each function has two implementations:

- the plain PyTorch versions (``*_reference``), which round where the TPU
  kernel bodies round: LayerNorm statistics in float32 (eps 1e-6) and its
  output cast to the compute type before the product; products accumulate
  in float32; each bias is added in float32, then cast; residual adds are
  in the compute type; GELU (tanh form) takes the rounded pre-activation;
  the attention is :func:`short_attention_reference` (float32 from the
  rounded qkv, P in float32, one rounding).  They are the kernels' oracles;
- ``csrc/fused_block.cu``, the CUDA kernels, built by nvcc at first use.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises (``NotImplementedError`` for a shape the kernels do not take: W a
multiple of 64 up to 512, the MLP hidden and the qkv width multiples of 64
up to 2048, N <= 32, D a multiple of 8 up to 128).

Gradients, as in the JAX package, recompute in plain ops: the backward of
each function is autograd of the composition the JAX package
differentiates (``_ln_qkv_reference``, ``_proj_mlp_reference``,
``_full_block_reference``, whose attention is
:func:`attention_reference_xla`); :func:`fused_ln_qkv_attn`'s backward
recomputes qkv and runs the attention backward kernel (``bwd_kernel``) or
autograd of :func:`attention_reference_xla`.  Each public function counts
its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch
import torch.nn.functional as F

from vit_marl_tpu_torch.ops import nvcc
from vit_marl_tpu_torch.ops.attention_kernel import (
    MAX_TOKENS,
    attention_bwd,
    attention_reference_xla,
    attention_xla_bwd,
    short_attention_reference,
)

SOURCE = os.path.join(nvcc.CSRC, "fused_block.cu")
EPS = 1e-6
MAX_WIDTH = 512
MAX_HIDDEN = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KINDS = {"fused_ln_qkv": 0, "fused_proj_mlp": 1, "fused_block_full": 2,
         "fused_ln_qkv_attn": 3}


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _acc_type(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (float64 stays float64):
    the mean, then the mean of squared deviations, eps 1e-6."""
    xf = x.to(_acc_type(x))
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + EPS)
    return y * gamma.to(y.dtype) + beta.to(y.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a w^T + b`` with float32 products and bias, cast to a's type."""
    acc = _acc_type(a)
    return F.linear(a.to(acc), w.to(acc), b.to(acc)).to(a.dtype)


def ln_qkv_reference(x, gamma, beta, w, bias):
    return dense(layer_norm(x, gamma, beta).to(x.dtype), w, bias)


def proj_mlp_reference(attn, x, wp, bp, gamma, beta, w1, b1, w2, b2):
    x1 = x + dense(attn, wp, bp)
    h = layer_norm(x1, gamma, beta).to(x.dtype)
    return x1 + dense(gelu(dense(h, w1, b1)), w2, b2)


def full_block_reference(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2,
                         bm2, n_tokens, heads,
                         attention=short_attention_reference):
    """The whole block.  With the default ``attention`` the kernel's
    numerics; with :func:`attention_reference_xla` the JAX package's
    ``_full_block_reference``, which its backward differentiates."""
    attn = attention(ln_qkv_reference(x, g1, b1, wqkv, bqkv), n_tokens,
                     heads)
    return proj_mlp_reference(attn, x, wp, bp, g2, b2, w1, bm1, w2, bm2)


def ln_qkv_attn_reference(x, gamma, beta, w, bias, n_tokens, heads,
                          attention=short_attention_reference):
    return attention(ln_qkv_reference(x, gamma, beta, w, bias), n_tokens,
                     heads)


def _full_block_xla(*args):
    return full_block_reference(*args, attention=attention_reference_xla)


# --------------------------------------------------------------------------
# CUDA kernels: build, load, launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile ``csrc/fused_block.cu`` (see ``ops/nvcc.py``); returns the
    library's path."""
    return nvcc.build(SOURCE, "libfused_block.so")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.fused_ln_qkv.argtypes = [p] * 6 + [i] * 4 + [p]
            lib.fused_proj_mlp.argtypes = [p] * 11 + [i] * 4 + [p]
            lib.fused_block_full.argtypes = [p] * 14 + [i] * 5 + [f, i, p]
            lib.fused_ln_qkv_attn.argtypes = [p] * 6 + [i] * 4 + [f, i, p]
            lib.fused_block_plan.argtypes = [i] * 8 + [p]
            for fn in (lib.fused_ln_qkv, lib.fused_proj_mlp,
                       lib.fused_block_full, lib.fused_ln_qkv_attn,
                       lib.fused_block_plan):
                fn.restype = i
            lib.fused_block_error_string.argtypes = [i]
            lib.fused_block_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _unsupported(name: str, why: str):
    raise NotImplementedError(f"{name}: the CUDA kernel does not take {why}")


def _check_width(name: str, what: str, n: int, most: int) -> None:
    if n % 64 or not 64 <= n <= most:
        _unsupported(name, f"{what}={n} (a multiple of 64 up to {most})")


def _check_heads(name: str, rows: int, W: int, n_tokens: int,
                 heads: int) -> None:
    if rows % n_tokens:
        raise ValueError(f"{name}: {rows} rows do not split into images of "
                         f"{n_tokens} tokens")
    if W % heads:
        raise ValueError(f"{name}: width {W} does not split into {heads} "
                         "heads")
    D = W // heads
    if not 1 <= n_tokens <= MAX_TOKENS or D % 8 or D > 128:
        _unsupported(name, f"N={n_tokens}, D={D} (N <= {MAX_TOKENS}, D a "
                     "multiple of 8 up to 128)")


def _kernel_tensors(name: str, rows_args, params):
    """Row tensors and weights in the compute type, LayerNorm parameters
    and biases in float32; all contiguous, 16-byte aligned, on one card."""
    dt = rows_args[0].dtype
    if dt not in _DTYPES:
        _unsupported(name, f"{dt} (float32 or bfloat16)")
    dev = rows_args[0].device
    out = []
    for t in rows_args:
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: rows and weights must share dtype "
                             f"{dt} and device {dev}, got {t.dtype} on "
                             f"{t.device}")
        out.append(t.contiguous())
    out += [t.to(device=dev, dtype=torch.float32).contiguous()
            for t in params]
    for t in out:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs 16-byte "
                             "aligned tensors")
    return out, _DTYPES[dt]


def _run(name: str, x: torch.Tensor, out: torch.Tensor, args) -> None:
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fused_block_error_string(err).decode())
    globals()[name].launches += 1


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _launch_ln_qkv(x, gamma, beta, w, bias):
    name = "fused_ln_qkv"
    rows, W = x.shape
    K = w.shape[0]
    _check_width(name, "W", W, MAX_WIDTH)
    _check_width(name, "K", K, MAX_HIDDEN)
    (x, w, gamma, beta, bias), code = _kernel_tensors(
        name, (x, w), (gamma, beta, bias))
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    _run(name, x, out, _ptrs((x, gamma, beta, w, bias, out))
         + [rows, W, K, code])
    return out


def _launch_proj_mlp(attn, x, wp, bp, gamma, beta, w1, b1, w2, b2):
    name = "fused_proj_mlp"
    rows, W = x.shape
    _check_width(name, "W", W, MAX_WIDTH)
    _check_width(name, "hidden", w1.shape[0], MAX_HIDDEN)
    (attn, x, wp, w1, w2, bp, gamma, beta, b1, b2), code = _kernel_tensors(
        name, (attn, x, wp, w1, w2), (bp, gamma, beta, b1, b2))
    out = torch.empty_like(x)
    _run(name, x, out,
         _ptrs((attn, x, wp, bp, gamma, beta, w1, b1, w2, b2, out))
         + [rows, W, w1.shape[0], code])
    return out


def _launch_full_block(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2,
                       bm2, n_tokens, heads):
    name = "fused_block_full"
    rows, W = x.shape
    _check_width(name, "W", W, MAX_WIDTH)
    _check_width(name, "hidden", w1.shape[0], MAX_HIDDEN)
    _check_heads(name, rows, W, n_tokens, heads)
    (x, wqkv, wp, w1, w2, g1, b1, bqkv, bp, g2, b2, bm1, bm2), code = \
        _kernel_tensors(name, (x, wqkv, wp, w1, w2),
                        (g1, b1, bqkv, bp, g2, b2, bm1, bm2))
    out = torch.empty_like(x)
    _run(name, x, out,
         _ptrs((x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2, bm2,
                out))
         + [rows, n_tokens, heads, W, w1.shape[0], (W // heads) ** -0.5,
            code])
    return out


def _launch_ln_qkv_attn(x, gamma, beta, w, bias, n_tokens, heads):
    name = "fused_ln_qkv_attn"
    rows, W = x.shape
    _check_width(name, "W", W, MAX_WIDTH)
    _check_heads(name, rows, W, n_tokens, heads)
    (x, w, gamma, beta, bias), code = _kernel_tensors(
        name, (x, w), (gamma, beta, bias))
    out = torch.empty_like(x)
    _run(name, x, out, _ptrs((x, gamma, beta, w, bias, out))
         + [rows, n_tokens, heads, W, (W // heads) ** -0.5, code])
    return out


def tile_plan(name: str, dtype: torch.dtype, width: int, n_tokens: int = 1,
              heads: int = 1, out_width: int = 0, hidden: int = 0) -> dict:
    """The tile the kernel ``name`` launches with at this shape: rows and
    images per block, heads per qkv group, shared-memory bytes."""
    plan = (ctypes.c_int * 4)()
    err = _library().fused_block_plan(
        KINDS[name], n_tokens, n_tokens, heads, width, out_width, hidden,
        _DTYPES[dtype], ctypes.addressof(plan))
    if err:
        raise ValueError(f"{name}: no plan for this shape")
    return dict(rows=plan[0], images=plan[1], head_group=plan[2],
                smem_bytes=plan[3])


# --------------------------------------------------------------------------
# Differentiable wrappers
# --------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def _vjp(ctx, fn, g, *extra):
    """Gradients of ``fn(*saved, *extra)`` for the inputs that need them,
    by autograd of the plain composition; ``g`` is the output's cotangent,
    or a function of the (detached) output that returns it."""
    saved = ctx.saved_tensors     # unpacked once: remat allows no more
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = fn(*xs, *extra)
        if callable(g):
            g = g(out.detach())
        wanted = [t for t in xs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if n else None for n in need)


class _LnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if _on_cpu(args[0]):
            return ln_qkv_reference(*args)
        return _launch_ln_qkv(*args)

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, ln_qkv_reference, g)


class _ProjMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if _on_cpu(args[0]):
            return proj_mlp_reference(*args)
        return _launch_proj_mlp(*args)

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, proj_mlp_reference, g)


class _FullBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        *tensors, n_tokens, heads = args
        ctx.save_for_backward(*tensors)
        ctx.n_tokens, ctx.heads = n_tokens, heads
        if _on_cpu(args[0]):
            return full_block_reference(*args)
        return _launch_full_block(*args)

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, _full_block_xla, g, ctx.n_tokens,
                    ctx.heads) + (None, None)


class _LnQkvAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, n_tokens, heads, bwd_kernel):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.n_tokens, ctx.heads = n_tokens, heads
        ctx.bwd_kernel = bwd_kernel
        args = (x, gamma, beta, w, bias, n_tokens, heads)
        if _on_cpu(x):
            return ln_qkv_attn_reference(*args)
        return _launch_ln_qkv_attn(*args)

    @staticmethod
    def backward(ctx, g):
        """qkv recomputed in plain ops, the attention's backward by the
        kernel (or autograd of the XLA-form attention), then autograd of
        LN1 + QKV."""
        bwd = attention_bwd if ctx.bwd_kernel else attention_xla_bwd
        return _vjp(ctx, ln_qkv_reference,
                    lambda qkv: bwd(qkv, g, ctx.n_tokens, ctx.heads)
                    ) + (None,) * 3


def fused_ln_qkv(x, gamma, beta, w, bias):
    """``LN(x) w^T + bias``: x ``(rows, W)``, w ``(K, W)`` -> ``(rows, K)``
    in x's type; differentiable."""
    return _LnQkv.apply(x, gamma, beta, w, bias)


def fused_proj_mlp(attn, x, wp, bp, gamma, beta, w1, b1, w2, b2):
    """``x1 = x + attn wp^T + bp``; ``x1 + mlp(LN(x1))`` with the tanh GELU:
    attn, x ``(rows, W)``, w1 ``(hidden, W)``, w2 ``(W, hidden)``;
    differentiable."""
    return _ProjMlp.apply(attn, x, wp, bp, gamma, beta, w1, b1, w2, b2)


def fused_block_full(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2, bm2,
                     n_tokens: int, heads: int):
    """The whole pre-LN block on ``(B*N, W)`` rows; differentiable."""
    return _FullBlock.apply(x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1,
                            w2, bm2, n_tokens, heads)


def fused_ln_qkv_attn(x, gamma, beta, w, bias, n_tokens: int, heads: int,
                      bwd_kernel: bool = True):
    """``attention(LN(x) w^T + bias)``: ``(B*N, W)`` rows -> ``(B*N, W)``
    attention rows before the projection; differentiable."""
    return _LnQkvAttn.apply(x, gamma, beta, w, bias, n_tokens, heads,
                            bwd_kernel)


for _fn in (fused_ln_qkv, fused_proj_mlp, fused_block_full,
            fused_ln_qkv_attn):
    _fn.launches = 0
