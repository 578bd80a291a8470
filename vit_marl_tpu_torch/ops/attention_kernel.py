"""Short-sequence attention over flat qkv rows, forward and backward.

Replaces the TPU kernels ``vit_marl_tpu/ops/attention_kernel.py::
_kernel_call`` (body ``_attn_body``) and ``_bwd_kernel_call`` (body
``_attn_bwd_body``), the ``custom_vjp`` pair behind
``fused_short_attention``.  Per image of N tokens and H heads of width D:
``qkv`` rows ``(B*N, 3W)``, lanes ``[q | k | v]`` with heads contiguous
(lane ``h*D + d`` of each third), as the ViT's fused QKV projection gives
them; the result is the ``(B*N, W)`` attention rows before the output
projection, in the input type.  Logits, softmax and products are float32
and each output is rounded once.

Two implementations of each direction:

- :func:`short_attention_reference` / :func:`short_attention_bwd_reference`,
  plain PyTorch;
- ``csrc/short_attention.cu``, the CUDA kernels, on one of two routes
  chosen by the dtype alone: bfloat16 takes the tensor-core route
  (``mma``: ``mma.sync`` tiles, persistent warps that load the next
  (image, head) while they compute this one), float32 the CUDA-core route
  (``simt``: one block per image, one warp per head, float32 FMAs).

:func:`short_attention` is the differentiable wrapper the ViT calls: its
forward saves ``qkv`` (not the output) and its backward runs the backward
kernel.  A CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises.  ``short_attention.launches_fwd`` and
``short_attention.launches_bwd`` count kernel launches, and
``short_attention.launches_{fwd,bwd}_{mma,simt}`` count them by route.

:func:`attention_reference_xla` is the JAX package's XLA attention, which
rounds P to the input type; the ViT's modes without the kernels run it,
and the fused blocks' backwards differentiate it, as the JAX package's
do.  :func:`dot_product_attention` is the JAX package's attention past 32
tokens (``models/vit.py::dot_product_attention``), in plain PyTorch, as
the JAX package computes it in XLA; ``dot_product_attention.calls``
counts its calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from vit_marl_tpu_torch.ops import nvcc, tally

SOURCE = os.path.join(nvcc.CSRC, "short_attention.cu")
MAX_TOKENS = 32
# the kernels' route for each dtype: tensor cores or CUDA cores
ROUTES = {torch.bfloat16: "mma", torch.float32: "simt"}


def _split(qkv: torch.Tensor, n_tokens: int, heads: int):
    """``(B*N, 3W)`` -> q, k, v as ``(B, H, N, D)`` in at least float32,
    and the scale ``D ** -0.5``."""
    rows, w3 = qkv.shape
    W = w3 // 3
    D = W // heads
    x = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
    x = x.reshape(rows // n_tokens, n_tokens, 3, heads, D).permute(
        2, 0, 3, 1, 4)
    return x[0], x[1], x[2], D ** -0.5


def short_attention_reference(qkv: torch.Tensor, n_tokens: int,
                              heads: int) -> torch.Tensor:
    """Plain PyTorch forward with the TPU kernel's numerics: the input is
    cast to float32 (float64 stays float64), q is scaled before the
    logits, softmax and ``P v`` run in float32, and the result is rounded
    once to the input type.

    This is not ``vit_marl_tpu/ops/attention_kernel.py::
    _attention_reference``, which rounds P to the input type before
    ``P v``: the two differ at bf16 and agree at float32.
    """
    q, k, v, scale = _split(qkv, n_tokens, heads)
    p = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
    B, H, N, D = q.shape
    return (p @ v).transpose(1, 2).reshape(B * N, H * D).to(qkv.dtype)


def short_attention_bwd_reference(qkv: torch.Tensor, g: torch.Tensor,
                                  n_tokens: int, heads: int) -> torch.Tensor:
    """Plain PyTorch backward: ``(B*N, 3W)`` qkv and ``(B*N, W)`` output
    cotangent -> ``(B*N, 3W)`` qkv cotangent, float32 math, one rounding::

        qs = q*scale; P = softmax(qs k^T); dv = P^T g; dP = g v^T
        delta = rowsum(P*dP); dS = P*(dP - delta)
        dq = dS k * scale; dk = dS^T qs
    """
    q, k, v, scale = _split(qkv, n_tokens, heads)
    B, H, N, D = q.shape
    gh = g.to(q.dtype).reshape(B, N, H, D).transpose(1, 2)
    qs = q * scale
    p = torch.softmax(qs @ k.transpose(-1, -2), dim=-1)
    dv = p.transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ qs
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)  # (B,N,3,H,D)
    return dqkv.reshape(B * N, 3 * H * D).to(qkv.dtype)


def attention_reference_xla(qkv: torch.Tensor, n_tokens: int,
                            heads: int) -> torch.Tensor:
    """A copy of the JAX package's XLA attention (``vit_marl_tpu/ops/
    attention_kernel.py::_attention_reference``, the same math as
    ``models/vit.py::attention_nhd``) on the flat layout, in its rounding:
    q is scaled in the input type; each product ``q_d k_d`` is rounded to
    the input type and the logits summed in float32; the float32 softmax
    P is rounded to the input type; each product ``P v_d`` is rounded and
    the sum taken in float32, then rounded once.  It materialises
    ``(B, N, N, H, D)`` products, as the XLA code does.  Differentiable by
    autograd; the JAX package's backwards of the fused blocks
    differentiate it.
    """
    rows, w3 = qkv.shape
    W = w3 // 3
    D = W // heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    x = qkv.reshape(rows // n_tokens, n_tokens, 3, heads, D)
    q = x[:, :, 0] * D ** -0.5                            # (B, N, H, D)
    k, v = x[:, :, 1], x[:, :, 2]
    logits = (q[:, :, None] * k[:, None]).to(acc).sum(-1)  # (B, Nq, Nk, H)
    p = torch.softmax(logits, dim=2).to(qkv.dtype)
    out = (p[..., None] * v[:, None]).to(acc).sum(2)        # (B, Nq, H, D)
    return out.reshape(rows, W).to(qkv.dtype)


def dot_product_attention(qkv: torch.Tensor, n_tokens: int,
                          heads: int) -> torch.Tensor:
    """The JAX package's attention over more than 32 tokens
    (``vit_marl_tpu/models/vit.py::dot_product_attention``, which MHA
    takes for N > 32) on flat ``(B*N, 3W)`` qkv rows, in its rounding: q
    scaled in the input type, logits as float32 products and sums of
    the (exactly widened) operands, the float32 softmax rounded to the
    input type, ``P v`` in float32 and rounded once.  Batched products
    of ``(B, H, N, D)``; differentiable by autograd.  No TF32: the ViT
    turns it off for every float32 product."""
    rows, w3 = qkv.shape
    W = w3 // 3
    D = W // heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    x = qkv.reshape(rows // n_tokens, n_tokens, 3, heads, D).permute(
        2, 0, 3, 1, 4)                                     # (3, B, H, N, D)
    q = (x[0] * D ** -0.5).to(acc)
    k, v = x[1].to(acc), x[2].to(acc)
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(qkv.dtype)
    out = (p.to(acc) @ v).to(qkv.dtype)                    # (B, H, N, D)
    tally(qkv, dot_product_attention, "calls")
    return out.transpose(1, 2).reshape(rows, W)


dot_product_attention.calls = 0


# --------------------------------------------------------------------------
# CUDA kernels: build, load, launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile ``csrc/short_attention.cu`` (see ``ops/nvcc.py``); returns
    the library's path."""
    return nvcc.build(SOURCE, "libshort_attention.so")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for route in ROUTES.values():
                fwd = getattr(lib, f"short_attention_fwd_{route}")
                fwd.argtypes = [p, p, i, i, i, i, f, p]
                fwd.restype = i
                bwd = getattr(lib, f"short_attention_bwd_{route}")
                bwd.argtypes = [p, p, p, i, i, i, i, f, p]
                bwd.restype = i
            lib.short_attention_error_string.argtypes = [i]
            lib.short_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_shape(qkv: torch.Tensor, n_tokens: int, heads: int):
    """Validate the layout; returns (B, D)."""
    if qkv.dim() != 2 or qkv.shape[1] % 3:
        raise ValueError(f"qkv must be (B*N, 3W), got {tuple(qkv.shape)}")
    rows, w3 = qkv.shape
    W = w3 // 3
    if rows % n_tokens or W % heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into "
                         f"{n_tokens} tokens and {heads} heads")
    return rows // n_tokens, W // heads


def _kernel_args(qkv: torch.Tensor, n_tokens: int, heads: int, name: str):
    """Checks for the CUDA kernels; returns (B, D, route)."""
    B, D = _check_shape(qkv, n_tokens, heads)
    if qkv.dtype not in ROUTES:
        raise ValueError(f"{name}: the CUDA kernel takes float32 or "
                         f"bfloat16, got {qkv.dtype}")
    if not 1 <= n_tokens <= MAX_TOKENS or D % 8 or not 8 <= D <= 128:
        raise ValueError(f"{name}: the CUDA kernel takes N <= {MAX_TOKENS} "
                         f"and D a multiple of 8 up to 128, got N="
                         f"{n_tokens}, D={D}")
    return B, D, ROUTES[qkv.dtype]


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels move 16-byte vectors."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


def _on_device(device: torch.device):
    """Makes ``device`` current for a launch; nothing to do when it is
    (the common case, which then skips the context's host time)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + _library().short_attention_error_string(err)
                           .decode())


def _launch_fwd(qkv: torch.Tensor, n_tokens: int, heads: int):
    B, D, route = _kernel_args(qkv, n_tokens, heads, "short_attention_fwd")
    qkv = qkv.contiguous()
    _check_aligned(qkv)
    out = torch.empty((qkv.shape[0], qkv.shape[1] // 3), dtype=qkv.dtype,
                      device=qkv.device)
    lib = _library()
    with _on_device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = getattr(lib, f"short_attention_fwd_{route}")(
            qkv.data_ptr(), out.data_ptr(), B, n_tokens, heads, D,
            D ** -0.5, stream)
    _raise_on(err, f"short_attention_fwd_{route}")
    tally(qkv, short_attention, "launches_fwd", f"launches_fwd_{route}")
    return out


def _launch_bwd(qkv: torch.Tensor, g: torch.Tensor, n_tokens: int,
                heads: int):
    B, D, route = _kernel_args(qkv, n_tokens, heads, "short_attention_bwd")
    qkv = qkv.contiguous()
    g = g.to(qkv.dtype).contiguous()
    if g.shape != (qkv.shape[0], qkv.shape[1] // 3) or g.device != qkv.device:
        raise ValueError(f"g: want {(qkv.shape[0], qkv.shape[1] // 3)} on "
                         f"{qkv.device}, got {tuple(g.shape)} on {g.device}")
    _check_aligned(qkv, g)
    dqkv = torch.empty_like(qkv)
    lib = _library()
    with _on_device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = getattr(lib, f"short_attention_bwd_{route}")(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), B, n_tokens,
            heads, D, D ** -0.5, stream)
    _raise_on(err, f"short_attention_bwd_{route}")
    tally(qkv, short_attention, "launches_bwd", f"launches_bwd_{route}")
    return dqkv


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def attention_fwd(qkv: torch.Tensor, n_tokens: int,
                  heads: int) -> torch.Tensor:
    """:func:`short_attention_reference` on either device: the plain
    version for a CPU tensor, the forward kernel for a CUDA one."""
    if _device_type(qkv) == "cpu":
        return short_attention_reference(qkv, n_tokens, heads)
    return _launch_fwd(qkv, n_tokens, heads)


def attention_bwd(qkv: torch.Tensor, g: torch.Tensor, n_tokens: int,
                  heads: int) -> torch.Tensor:
    """The backward of :func:`short_attention_reference` on either device:
    the plain version for a CPU tensor, the backward kernel for a CUDA
    one."""
    if _device_type(qkv) == "cpu":
        return short_attention_bwd_reference(qkv, g, n_tokens, heads)
    return _launch_bwd(qkv, g, n_tokens, heads)


def attention_xla_bwd(qkv: torch.Tensor, g: torch.Tensor, n_tokens: int,
                      heads: int) -> torch.Tensor:
    """Autograd of :func:`attention_reference_xla` at ``qkv``."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        (dqkv,) = torch.autograd.grad(
            attention_reference_xla(x, n_tokens, heads), x, g)
    return dqkv


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_tokens, heads, bwd_kernel):
        ctx.save_for_backward(qkv)
        ctx.n_tokens, ctx.heads, ctx.bwd_kernel = n_tokens, heads, bwd_kernel
        return attention_fwd(qkv, n_tokens, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        bwd = attention_bwd if ctx.bwd_kernel else attention_xla_bwd
        return bwd(qkv, g, ctx.n_tokens, ctx.heads), None, None, None


def short_attention(qkv: torch.Tensor, n_tokens: int, heads: int,
                    bwd_kernel: bool = True) -> torch.Tensor:
    """Attention over flat ``(B*N, 3W)`` qkv rows -> ``(B*N, W)`` rows in
    the input type; differentiable.  Any B; on the card N <= 32, D a
    multiple of 8 up to 128, float32 or bfloat16.  ``bwd_kernel=False``
    differentiates :func:`attention_reference_xla` instead of running the
    backward kernel (``ViTConfig.attn_bwd_kernel``).  Where no gradient
    can flow (``no_grad``, as in the rollout, or ``qkv`` without
    ``requires_grad``) the forward runs without the autograd Function,
    whose host time per call would be most of a small launch's."""
    _check_shape(qkv, n_tokens, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _ShortAttention.apply(qkv, n_tokens, heads, bwd_kernel)
    return attention_fwd(qkv, n_tokens, heads)


short_attention.launches_fwd = 0
short_attention.launches_bwd = 0
short_attention.launches_fwd_mma = 0
short_attention.launches_fwd_simt = 0
short_attention.launches_bwd_mma = 0
short_attention.launches_bwd_simt = 0
