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
  Each function has two routes, chosen by the dtype alone: bf16 runs the
  tensor-core kernels (wgmma on a TMA-fed weight ring, on the tile plan
  of :func:`wgmma_plan`, computed here and checked by the C entry;
  :func:`fused_ln_qkv_attn`'s attention on ``mma.sync`` tiles), float32
  the CUDA-core kernels; each counts its launches in ``.launches_wgmma``
  / ``.launches_simt`` beside the total ``.launches``.  Past 32 tokens
  :func:`fused_block_full` and :func:`fused_ln_qkv_attn` run on their
  route as three kernels on one stream, the qkv rows staged through a
  global buffer: ``fused_ln_qkv``'s kernel (K = 3W), the attention of
  ``csrc/long_attention.cuh`` (keys in tiles of 32, online softmax; bf16
  on ``mma.sync``), and for the full block ``fused_proj_mlp``'s kernel;
  the call counts once, under its own name and route.

A third route, ``composed``, runs the JAX package's composed XLA
reference (``_ln_qkv_reference``, ``_proj_mlp_reference``,
``_full_block_reference``, ``_ln_qkv_attn_reference``) in its numerics:
the plain versions below, whose products widen the operands to float32
(float32 products and sums, as ``jnp.dot(..., preferred_element_type=
f32)``) and add the float32 bias before the one rounding, with LayerNorm
in float32 (eps 1e-6), the tanh GELU and, for the attention, the XLA-form
:func:`attention_reference_xla` (the compositions the backwards
differentiate).  It is chosen by shape alone, before any launch, exactly
where the JAX package's guards send a shape to XLA (:func:`fits_kernel`:
W over 512, the LN+QKV output or the MLP hidden over 2048), on any
device, and counted in ``.launches_composed`` (not in ``.launches``: it
launches no kernel of its own).  The JAX guards' row alignment and
backend conditions are not taken: the kernels take ragged rows.

Otherwise a CPU tensor takes the plain versions, and a CUDA tensor
launches the kernel or raises (``NotImplementedError`` for a shape the
kernels do not take: W a multiple of 64 up to 512, the MLP hidden and the
qkv width multiples of 64 up to 2048, D a multiple of 8 up to 128; any
number of tokens).

Gradients, as in the JAX package, recompute in plain ops: the backward of
each function is autograd of the composition the JAX package
differentiates (``_ln_qkv_reference``, ``_proj_mlp_reference``,
``_full_block_reference``, whose attention is
:func:`attention_reference_xla`); :func:`fused_ln_qkv_attn`'s backward
recomputes qkv and runs the attention backward kernel (``bwd_kernel``,
up to 32 tokens, as the JAX package's ``_ln_qkv_attn_bwd`` takes it only
where its ``attention_ok`` holds) or autograd of
:func:`attention_reference_xla`.  Each public function counts
its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch
import torch.nn.functional as F

from vit_marl_tpu_torch.ops import nvcc, tally
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


def _ln_qkv_attn_xla(*args):
    return ln_qkv_attn_reference(*args, attention=attention_reference_xla)


# --------------------------------------------------------------------------
# The composed route: the JAX package's XLA reference, for shapes past its
# kernels' width guards
# --------------------------------------------------------------------------

def fits_kernel(name: str, width: int, hidden: int = 0) -> bool:
    """Whether the JAX package sends a shape of ``name`` to its kernel and
    not to its composed XLA reference, by width alone: W up to
    ``MAX_WIDTH``; ``hidden`` (``fused_ln_qkv``: its K output columns; the
    MLP's hidden width) up to ``MAX_HIDDEN``; ``fused_ln_qkv_attn`` has
    no hidden guard (ref: block_kernel.py:101-104, :182-186,
    ``full_block_ok``, ``ln_qkv_attn_ok``).  False selects the
    ``composed`` route."""
    if name not in KINDS:
        raise ValueError(f"unknown fused-block function {name!r}")
    if name == "fused_ln_qkv_attn":
        hidden = 0
    return width <= MAX_WIDTH and hidden <= MAX_HIDDEN


def _composed(name: str, fn, *args):
    """Run the composed route of ``name`` and count it."""
    tally(args[0], globals()[name], "launches_composed")
    return fn(*args)


# --------------------------------------------------------------------------
# The tile plan of the bf16 tensor-core kernels
# --------------------------------------------------------------------------

SMEM_LIMIT = 232_448      # shared memory a block may use on an H100
TC_ROWS = 64              # token rows of a tile: wgmma's M
TC_KB_BYTES = TC_ROWS * 128   # one 64-column k-block of a tile, swizzled
TC_SLOT_BYTES = 64 * 128      # a ring slot: 64 weight rows of a k-block
TC_MAX_SLOTS = 32
TC_CLUSTER = 2            # CTAs sharing each weight byte read from L2
# the fields of the C struct tc::Plan, in order
TC_FIELDS = ("kind", "rows", "images", "cluster", "stages", "stage_bytes",
             "head_group", "slot", "gdp", "hc", "hid_bufs", "ldq",
             "attn_warps", "o_h", "o_qkv", "o_p", "o_at", "o_hid", "o_bias",
             "o_bar", "smem", "nc", "qkv_rows")
TC_MIN_STAGES = 4         # kernels 6a and 5: the ring they are planned for


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _ring(rest: int, slot: int = TC_SLOT_BYTES) -> int:
    """Ring slots that fit beside ``rest`` bytes of tiles: each slot
    ``slot`` bytes and a pair of 8-byte mbarriers, 1 KB kept to align
    the base."""
    return min(TC_MAX_SLOTS, (SMEM_LIMIT - 1024 - rest) // (slot + 16))


def _qkv_plan(name: str, W: int, K: int, N: int, heads: int,
              head_group: int, rows: int, nc: int) -> dict:
    """Kernels 6a (``fused_ln_qkv``, K output columns) and 5
    (``fused_ln_qkv_attn``, K = 3W); see :func:`wgmma_plan`."""
    attn = name == "fused_ln_qkv_attn"
    D = W // heads
    plans = []
    for R in [rows] if rows else (128, 64):
        for c in [nc] if nc else ((64,) if attn else (128, 64)):
            base = dict.fromkeys(TC_FIELDS, 0)
            base.update(kind=KINDS[name], rows=R, cluster=TC_CLUSTER, nc=c,
                        stage_bytes=c * 128, rows_per_fetch=TC_CLUSTER * R)
            a_tiles = R * W * 2
            if not attn:
                # the output staging: 64 rows x nc a warpgroup
                # the output staging: 64 rows x nc a warpgroup
                tiles = [a_tiles, R * c * 2, 4 * (_round_up(K, c) + 2 * W)]
                plans.append((base, tiles))
                continue
            images, DP = R // N, _round_up(D, 16)
            np_ = 16 if N <= 16 else 32
            qkv_rows = max(R, (images - 1) * N + np_)
            for G in [head_group] if head_group else range(heads, 0, -1):
                ldq = 3 * G * DP + 8
                plans.append((dict(base, images=images, head_group=G,
                                   slot=G * DP, ldq=ldq, qkv_rows=qkv_rows),
                              [a_tiles, _round_up(qkv_rows * ldq * 2, 16),
                               4 * 5 * W]))
    for base, tiles in plans:
        rest = sum(tiles) + 16
        stages = _ring(rest, base["stage_bytes"])
        if stages < (3 if rows or nc else TC_MIN_STAGES):
            continue
        at = stages * base["stage_bytes"]
        offs = []
        for b in tiles:
            offs.append(at)
            at += b
        o_h, o_qkv, o_bias = offs
        return dict(base, stages=stages, o_h=o_h, o_qkv=o_qkv,
                    o_bias=o_bias, o_bar=at, smem=at + 16 * stages + 16
                    + 1024)
    raise ValueError(f"{name}: no tile plan for W={W}, K={K}, N={N}, "
                     f"D={D}")


@functools.lru_cache(maxsize=None)
def wgmma_plan(name: str, width: int, hidden: int, n_tokens: int = 1,
               heads: int = 1, head_group: int = 0, rows: int = 0,
               nc: int = 0) -> dict:
    """The tile plan of the bf16 kernel ``name`` at width W, ``hidden``
    (the MLP's hidden width; ``fused_ln_qkv``: its K output columns), N
    tokens and H heads; its fields are ``TC_FIELDS`` (shared-memory
    offsets in bytes from the ring at 0), and ``rows_per_fetch``, the
    tile rows each weight byte read from L2 feeds.

    ``fused_ln_qkv`` and ``fused_ln_qkv_attn`` (kernels 6a and 5): a CTA
    tile of ``rows`` = 128 token rows (kernel 5: the ``images`` whole
    images that fit), each consumer warpgroup owning 64 and computing
    every output column for them, so each ring stage (``nc`` weight rows
    of a 64-column k-block) feeds both warpgroups: 256 rows a weight fetch
    with the cluster of 2.  The block input comes by TMA into the A tiles
    (``o_h``, rows x W), LN1 runs in place.  6a computes chunks of ``nc`` = 128
    output columns (64 where the ring would keep fewer than
    ``TC_MIN_STAGES`` stages) and stages each in ``o_qkv`` for its
    TMA store; 5 computes pieces of 64 columns of a head group's q, k and v
    into its qkv tile (``o_qkv``: ``qkv_rows`` rows of ``ldq``, each head
    ``slot / head_group`` columns, the head width padded to 16), the
    largest group whose ring keeps ``TC_MIN_STAGES`` stages.  Where none
    does at 128 rows, the tile is 64 rows, one consumer warpgroup.
    ``rows``, ``nc`` and ``head_group`` force a choice (plan variants).

    ``fused_proj_mlp`` and ``fused_block_full`` (kernels 6b and 7):

    A CTA holds 64 token rows (kernel 7: the whole images that fit) and a
    ring of ``stages`` weight slots of ``stage_bytes`` (64 rows of a
    64-column k-block); a consumer warpgroup's k-block (half a product's
    output columns) takes one slot per 64 rows.  A cluster of 2 CTAs
    shares each slot by multicast, so each weight byte read from L2 feeds
    128 tile rows (``rows_per_fetch``; ``fused_block_full``'s tiles hold
    whole images, 110 token rows at N=11).  The MLP runs in hidden chunks
    of ``hc`` columns, the largest of 256 (one GELU tile;
    ``fused_proj_mlp`` only), 128 and 64 (two GELU tiles) that divides the
    hidden width; the biases, LN2's scale and shift and its row statistics
    wait in shared memory.  ``fused_block_full`` computes qkv for a group of heads at a time: the
    group's width padded to ``gdp`` (at most 192), each of q, k and v in
    products of at most 64 of a warpgroup's columns; the attention's
    output (``slot`` columns, zeros past the group's heads) is the
    projection's k dimension.  It takes the largest group (fewest rounds
    of attention) whose ring holds three of the widest k-blocks and a
    slot for each warpgroup's next (at ViT-Small a group of 2 heads, 11
    slots, measured faster than 3 heads with 7), else the group with the
    most slots (or ``head_group`` heads, if given)."""
    W = width
    if name in ("fused_ln_qkv", "fused_ln_qkv_attn"):
        return _qkv_plan(name, W, hidden if name == "fused_ln_qkv" else 3 * W,
                         n_tokens, heads, head_group, rows, nc)
    # 6b: chunks of 256 and one GELU tile; kernel 7, whose registers also
    # hold the projection during the head groups: 128 and two
    hc = next(c for c in (256, 128, 64)
              if hidden % c == 0 and (name == "fused_proj_mlp" or c < 256))
    bufs = 1 if hc == 256 else 2
    tile = TC_ROWS * W * 2
    hid = bufs * TC_ROWS * hc * 2
    plan = dict.fromkeys(TC_FIELDS, 0)
    plan.update(rows=TC_ROWS, hc=hc, hid_bufs=bufs)
    if name == "fused_proj_mlp":
        bias = 4 * (4 * W + hidden + 256)
        rest = tile + hid + bias
        stages = _ring(rest)
        o_h = stages * TC_SLOT_BYTES
        plan.update(kind=KINDS[name], cluster=TC_CLUSTER, stages=stages,
                    stage_bytes=TC_SLOT_BYTES, o_h=o_h, o_hid=o_h + tile,
                    o_bias=o_h + tile + hid, o_bar=o_h + rest)
        plan.update(smem=plan["o_bar"] + 16 * stages + 1024,
                    rows_per_fetch=TC_CLUSTER * TC_ROWS)
        return plan
    if name != "fused_block_full":
        raise ValueError(f"{name}: no tensor-core plan")
    N, D = n_tokens, W // heads
    images = TC_ROWS // N
    best = None
    need = -(-max(W // 2, hc // 2) // 64)   # slots of a widest k-block
    for G in [head_group] if head_group else range(heads, 0, -1):
        gdp = _round_up(G * D, 64)
        if gdp > 192:
            continue
        slot = _round_up(G * D, 16)
        ldq = 3 * slot + 8
        attn_warps = min(8, images * G)
        qkv = _round_up(TC_ROWS * ldq * 2, 16)
        o_at = _round_up(max(qkv + attn_warps * N * (N + 1) * 4, hid), 1024)
        o_bias = o_at + -(-slot // 64) * TC_KB_BYTES
        rest = tile + o_bias + 4 * (7 * W + hidden + 256)
        stages = _ring(rest)
        if stages < 2 * need:
            continue
        o_h = stages * TC_SLOT_BYTES
        cand = dict(plan, kind=KINDS[name], images=images, cluster=TC_CLUSTER,
                    stages=stages, stage_bytes=TC_SLOT_BYTES, head_group=G,
                    slot=slot, gdp=gdp, ldq=ldq,
                    attn_warps=attn_warps, o_h=o_h, o_qkv=o_h + tile,
                    o_p=o_h + tile + qkv, o_at=o_h + tile + o_at,
                    o_hid=o_h + tile, o_bias=o_h + tile + o_bias,
                    o_bar=o_h + rest,
                    smem=o_h + rest + 16 * stages + 1024,
                    rows_per_fetch=TC_CLUSTER * TC_ROWS)
        if stages >= 3 * need + 2:
            return cand
        if best is None or stages > best["stages"]:
            best = cand
    if best is None:
        raise ValueError(f"{name}: no tile plan for W={W}, N={N}, D={D}")
    return best


@functools.lru_cache(maxsize=None)
def _plan_array(name, width, hidden, n_tokens, heads):
    """The plan as the C struct's ints (cached, so the address stays
    valid)."""
    plan = wgmma_plan(name, width, hidden, n_tokens, heads)
    return (ctypes.c_int * len(TC_FIELDS))(*(plan[k] for k in TC_FIELDS))


def _plan_ptr(*shape) -> int:
    return ctypes.addressof(_plan_array(*shape))


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
            lib.fused_proj_mlp_tc.argtypes = [p] * 11 + [i] * 3 + [p, p]
            lib.fused_block_full_tc.argtypes = ([p] * 14 + [i] * 5
                                                + [f, p, p])
            lib.fused_ln_qkv_tc.argtypes = [p] * 6 + [i] * 3 + [p, p]
            lib.fused_ln_qkv_attn_tc.argtypes = ([p] * 6 + [i] * 4
                                                 + [f, p, p])
            lib.fused_block_tc_info.argtypes = [i, p] + [i] * 4 + [p]
            lib.fused_block_long_attention.argtypes = ([p] * 2 + [i] * 4
                                                       + [f, i, p])
            for fn in (lib.fused_ln_qkv, lib.fused_proj_mlp,
                       lib.fused_block_full, lib.fused_ln_qkv_attn,
                       lib.fused_ln_qkv_tc, lib.fused_proj_mlp_tc,
                       lib.fused_block_full_tc, lib.fused_ln_qkv_attn_tc,
                       lib.fused_block_tc_info,
                       lib.fused_block_tc_plan_fields,
                       lib.fused_block_long_attention):
                fn.restype = i
            if lib.fused_block_tc_plan_fields() != len(TC_FIELDS):
                raise RuntimeError("fused_block.cu's tc::Plan does not "
                                   "match TC_FIELDS")
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
    if D % 8 or D > 128:
        _unsupported(name, f"D={D} (a multiple of 8 up to 128)")


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


def _run(entry: str, x: torch.Tensor, args) -> None:
    """Launch the C entry ``entry`` on x's card."""
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.fused_block_error_string(err).decode())


def _entry(name: str, x: torch.Tensor) -> str:
    """The C entry of ``name`` for x's type: ``name_tc`` on the bf16
    tensor-core route, ``name`` on the float32 one."""
    return name + ("_tc" if x.dtype == torch.bfloat16 else "")


def _tally(name: str, x: torch.Tensor) -> None:
    """Count one call of ``name`` on x's card, in total and on its route
    (each public function counts its call once, whatever it launches)."""
    tally(x, globals()[name], "launches", f"launches_{_route(x)}")


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _route(x: torch.Tensor) -> str:
    return "wgmma" if x.dtype == torch.bfloat16 else "simt"


def _launch_ln_qkv(x, gamma, beta, w, bias):
    name = "fused_ln_qkv"
    rows, W = x.shape
    K = w.shape[0]
    _check_width(name, "W", W, MAX_WIDTH)
    _check_width(name, "K", K, MAX_HIDDEN)
    (x, w, gamma, beta, bias), code = _kernel_tensors(
        name, (x, w), (gamma, beta, bias))
    out = torch.empty((rows, K), dtype=x.dtype, device=x.device)
    args = _ptrs((x, gamma, beta, w, bias, out)) + [rows, W, K]
    plan = (_plan_ptr(name, W, K, 1, 1) if x.dtype == torch.bfloat16
            else code)
    _run(_entry(name, x), x, args + [plan])
    return out


def _launch_proj_mlp(attn, x, wp, bp, gamma, beta, w1, b1, w2, b2):
    name = "fused_proj_mlp"
    rows, W = x.shape
    _check_width(name, "W", W, MAX_WIDTH)
    _check_width(name, "hidden", w1.shape[0], MAX_HIDDEN)
    (attn, x, wp, w1, w2, bp, gamma, beta, b1, b2), code = _kernel_tensors(
        name, (attn, x, wp, w1, w2), (bp, gamma, beta, b1, b2))
    out = torch.empty_like(x)
    args = (_ptrs((attn, x, wp, bp, gamma, beta, w1, b1, w2, b2, out))
            + [rows, W, w1.shape[0]])
    plan = (_plan_ptr(name, W, w1.shape[0], 1, 1)
            if x.dtype == torch.bfloat16 else code)
    _run(_entry(name, x), x, args + [plan])
    return out


def _launch_long_attention(qkv, n_tokens: int, heads: int):
    """The attention of ``(B*N, 3W)`` qkv rows past 32 tokens
    (``csrc/long_attention.cuh``), the middle launch of kernels 5 and 7
    there."""
    rows, W = qkv.shape[0], qkv.shape[1] // 3
    out = torch.empty((rows, W), dtype=qkv.dtype, device=qkv.device)
    _run("fused_block_long_attention", qkv,
         [qkv.data_ptr(), out.data_ptr(), rows, n_tokens, heads, W,
          (W // heads) ** -0.5, _DTYPES[qkv.dtype]])
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
    if n_tokens > MAX_TOKENS:
        qkv = _launch_ln_qkv(x, g1, b1, wqkv, bqkv)
        attn = _launch_long_attention(qkv, n_tokens, heads)
        return _launch_proj_mlp(attn, x, wp, bp, g2, b2, w1, bm1, w2, bm2)
    out = torch.empty_like(x)
    args = (_ptrs((x, g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bm1, w2, bm2,
                   out))
            + [rows, n_tokens, heads, W, w1.shape[0], (W // heads) ** -0.5])
    plan = (_plan_ptr(name, W, w1.shape[0], n_tokens, heads)
            if x.dtype == torch.bfloat16 else code)
    _run(_entry(name, x), x, args + [plan])
    return out


def _launch_ln_qkv_attn(x, gamma, beta, w, bias, n_tokens, heads):
    name = "fused_ln_qkv_attn"
    rows, W = x.shape
    _check_width(name, "W", W, MAX_WIDTH)
    _check_heads(name, rows, W, n_tokens, heads)
    (x, w, gamma, beta, bias), code = _kernel_tensors(
        name, (x, w), (gamma, beta, bias))
    if n_tokens > MAX_TOKENS:
        return _launch_long_attention(
            _launch_ln_qkv(x, gamma, beta, w, bias), n_tokens, heads)
    out = torch.empty_like(x)
    args = (_ptrs((x, gamma, beta, w, bias, out))
            + [rows, n_tokens, heads, W, (W // heads) ** -0.5])
    plan = (_plan_ptr(name, W, 0, n_tokens, heads)
            if x.dtype == torch.bfloat16 else code)
    _run(_entry(name, x), x, args + [plan])
    return out


def wgmma_info(name: str, width: int, hidden: int, n_tokens: int = 1,
               heads: int = 1) -> dict:
    """The bf16 tensor-core kernel ``name`` at this shape on the current
    card (``hidden``: as :func:`wgmma_plan` takes it): its plan,
    registers and spill bytes a thread, and the clusters (and CTAs) one
    wave holds."""
    out = (ctypes.c_int * 3)()
    err = _library().fused_block_tc_info(
        KINDS[name], _plan_ptr(name, width, hidden, n_tokens, heads),
        n_tokens, heads, width, hidden, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{name}: " + _library().fused_block_error_string(
            err).decode())
    plan = wgmma_plan(name, width, hidden, n_tokens, heads)
    return dict(plan, registers=out[0], spill_bytes=out[1],
                clusters_per_wave=out[2],
                ctas_per_wave=out[2] * plan["cluster"])


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
        x, w = args[0], args[3]
        if not fits_kernel("fused_ln_qkv", x.shape[1], w.shape[0]):
            return _composed("fused_ln_qkv", ln_qkv_reference, *args)
        if _on_cpu(x):
            return ln_qkv_reference(*args)
        out = _launch_ln_qkv(*args)
        _tally("fused_ln_qkv", x)
        return out

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, ln_qkv_reference, g)


class _ProjMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        x, w1 = args[1], args[6]
        if not fits_kernel("fused_proj_mlp", x.shape[1], w1.shape[0]):
            return _composed("fused_proj_mlp", proj_mlp_reference, *args)
        if _on_cpu(x):
            return proj_mlp_reference(*args)
        out = _launch_proj_mlp(*args)
        _tally("fused_proj_mlp", x)
        return out

    @staticmethod
    def backward(ctx, g):
        return _vjp(ctx, proj_mlp_reference, g)


class _FullBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        *tensors, n_tokens, heads = args
        ctx.save_for_backward(*tensors)
        ctx.n_tokens, ctx.heads = n_tokens, heads
        x, w1 = args[0], args[9]
        if not fits_kernel("fused_block_full", x.shape[1], w1.shape[0]):
            return _composed("fused_block_full", _full_block_xla, *args)
        if _on_cpu(x):
            return full_block_reference(*args)
        out = _launch_full_block(*args)
        _tally("fused_block_full", x)
        return out

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
        if not fits_kernel("fused_ln_qkv_attn", x.shape[1]):
            return _composed("fused_ln_qkv_attn", _ln_qkv_attn_xla, *args)
        if _on_cpu(x):
            return ln_qkv_attn_reference(*args)
        out = _launch_ln_qkv_attn(*args)
        _tally("fused_ln_qkv_attn", x)
        return out

    @staticmethod
    def backward(ctx, g):
        """qkv recomputed in plain ops, the attention's backward by the
        kernel up to 32 tokens (else, or without ``bwd_kernel``, autograd
        of the XLA-form attention), then autograd of LN1 + QKV."""
        bwd = (attention_bwd if ctx.bwd_kernel
               and ctx.n_tokens <= MAX_TOKENS else attention_xla_bwd)
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
    _fn.launches = _fn.launches_wgmma = _fn.launches_simt = 0
    _fn.launches_composed = 0
