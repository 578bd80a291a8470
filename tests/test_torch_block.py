"""The port's fused-block functions against the JAX package's kernels.

The plain PyTorch versions of ``vit_marl_tpu_torch/ops/block_kernel.py``
take the same numpy-made inputs (width W=64, 2 heads, N=11 tokens, MLP x4)
as the Pallas kernels of ``vit_marl_tpu/ops/block_kernel.py`` in interpret
mode, at shapes where each JAX call runs its kernel, not its XLA fallback:
1,024 rows for ``fused_ln_qkv`` and ``fused_proj_mlp`` (its ``ROW_BLOCK``),
16 images with ``env_block=8`` for ``fused_block_full`` and
``fused_ln_qkv_attn`` (``full_block_ok`` / ``ln_qkv_attn_ok``).  float32
agrees within rtol 1e-5 / atol 1e-5; bf16 within 2e-2 (the two frameworks
round the sums of the products in another order, and the errors of the
LayerNorm, the products and the GELU add up to about a bf16 ulp).

The autograd backward of each wrapper matches ``jax.vjp`` of the JAX
function in float32 within 1e-5 (``fused_ln_qkv_attn`` with the attention
backward kernel and without), and passes ``gradcheck`` in float64.  On the
CPU the wrappers run the plain versions and count no launch; the CUDA
launchers refuse the shapes the kernels do not take before they touch a
card.

Past the JAX package's width guards (W over 512, the LN+QKV output or
the MLP hidden over 2048) the wrappers take the ``composed`` route, on
any device: ``fits_kernel`` is checked against where the JAX functions
reach ``pl.pallas_call``, the composed functions against the JAX ones
at ViT-Base's width, and the ViT-Base encoder (depth 2) in each fused
mode against flax, forward and gradients, in float32 within 1e-5.

The tile plan of the bf16 tensor-core kernels (``wgmma_plan``), which the
C entry only checks, is walked over every accepted shape (W, hidden, N,
D): it fits an H100's 232,448 bytes of shared memory with its regions in
order, kernel 7's tiles hold whole images, ViT-Small's shapes get 128
rows a weight fetch, and kernel 7's head groups cover every qkv column
and every attention column of the projection exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.ops import block_kernel as jbk
from vit_marl_tpu_torch.ops import block_kernel as bk

W, H, N, RATIO = 64, 2, 11, 4
EB, IMAGES = 8, 16
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype, weight=False):
    """One numpy array -> (jax, torch, is a weight) of the same values in
    ``dtype``; a weight goes to JAX as ``(in, out)`` and to the port as
    ``(out, in)``."""
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    j = jnp.asarray(t.float().numpy()).astype(jdt)
    return j, (t.T.contiguous() if weight else t), weight


def _f32(a):
    return jnp.asarray(a), torch.from_numpy(a), False


def _inputs(kind, dtype, seed, W=W, rows=None, scale=0.1, w2_scale=0.1):
    """(jax args, torch args, which are weights) of one function at width
    W; rows and weights in ``dtype``, LayerNorm parameters and biases
    float32."""
    rng = np.random.default_rng(seed)
    if rows is None:
        rows = 1024 if kind in ("ln_qkv", "proj_mlp") else IMAGES * N

    def normal(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.normal(size=shape)).astype(np.float32)

    x = _pair(normal(rows, W), dtype)
    ln = [_f32(normal(W, scale=0.1, loc=1.0)), _f32(normal(W, scale=0.1))]
    qkv = [_pair(normal(W, 3 * W, scale=scale), dtype, True),
           _f32(normal(3 * W, scale=0.1))]
    tail = [_pair(normal(W, W, scale=scale), dtype, True),
            _f32(normal(W, scale=0.1)),
            _f32(normal(W, scale=0.1, loc=1.0)), _f32(normal(W, scale=0.1)),
            _pair(normal(W, RATIO * W, scale=scale), dtype, True),
            _f32(normal(RATIO * W, scale=0.1)),
            _pair(normal(RATIO * W, W, scale=w2_scale), dtype, True),
            _f32(normal(W, scale=0.1))]
    if kind == "ln_qkv":
        pairs = [x] + ln + qkv
    elif kind == "proj_mlp":
        pairs = [_pair(normal(rows, W), dtype), x] + tail
    elif kind == "full_block":
        pairs = [x] + ln + qkv + tail
    else:
        pairs = [x] + ln + qkv
    return tuple(map(list, zip(*pairs)))


def _jax_fn(kind, bwd_kernel=True):
    """The JAX function with its kernel engaged (interpret mode)."""
    if kind == "ln_qkv":
        return lambda *a: jbk.fused_ln_qkv(*a, True)
    if kind == "proj_mlp":
        return lambda *a: jbk.fused_proj_mlp(*a, True)
    if kind == "full_block":
        return lambda *a: jbk.fused_block_full(*a, N, H, EB, True)
    return lambda *a: jbk.fused_ln_qkv_attn(*a, N, H, EB, True, bwd_kernel)


def _port(kind, bwd_kernel=True):
    """(plain version, differentiable wrapper) of the port."""
    if kind == "ln_qkv":
        return bk.ln_qkv_reference, bk.fused_ln_qkv
    if kind == "proj_mlp":
        return bk.proj_mlp_reference, bk.fused_proj_mlp
    if kind == "full_block":
        return (lambda *a: bk.full_block_reference(*a, N, H),
                lambda *a: bk.fused_block_full(*a, N, H))
    return (lambda *a: bk.ln_qkv_attn_reference(*a, N, H),
            lambda *a: bk.fused_ln_qkv_attn(*a, N, H, bwd_kernel))


def _kernel_engages(kind):
    """The JAX call takes its Pallas kernel at the test's shapes."""
    hidden = RATIO * W
    if kind in ("ln_qkv", "proj_mlp"):
        return 1024 % jbk.ROW_BLOCK == 0 and W <= jbk.MAX_WIDTH
    if kind == "full_block":
        return jbk.full_block_ok(IMAGES * N, N, W, H, hidden, EB)
    return jbk.ln_qkv_attn_ok(IMAGES * N, N, W, H, EB)


KINDS = ["ln_qkv", "proj_mlp", "full_block", "ln_qkv_attn"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_pallas_kernel(kind, dtype):
    assert _kernel_engages(kind)
    jargs, targs, _ = _inputs(kind, dtype, seed=KINDS.index(kind))
    want = _jax_fn(kind)(*jargs)
    plain, wrapper = _port(kind)
    got = plain(*targs)
    assert got.dtype == DTYPES[dtype][1] and want.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    # on the CPU the wrapper is the plain version, with no launch counted
    fn = {"ln_qkv": bk.fused_ln_qkv, "proj_mlp": bk.fused_proj_mlp,
          "full_block": bk.fused_block_full,
          "ln_qkv_attn": bk.fused_ln_qkv_attn}[kind]
    before = fn.launches
    assert torch.equal(wrapper(*targs), got)
    assert fn.launches == before


@pytest.mark.parametrize("kind,bwd_kernel", [
    ("ln_qkv", True), ("proj_mlp", True), ("full_block", True),
    ("ln_qkv_attn", True), ("ln_qkv_attn", False)],
    ids=["ln_qkv", "proj_mlp", "full_block", "ln_qkv_attn-kernel-bwd",
         "ln_qkv_attn-xla-bwd"])
def test_backward_matches_jax_vjp(kind, bwd_kernel):
    jargs, targs, weight = _inputs(kind, "float32",
                                   seed=10 + KINDS.index(kind))
    out, vjp = jax.vjp(_jax_fn(kind, bwd_kernel), *jargs)
    # a cotangent of scale 1/32: the weight gradients, sums over 1,024
    # rows, come out near unit scale
    g = (np.random.default_rng(3).normal(size=out.shape) / 32).astype(
        np.float32)
    want = vjp(jnp.asarray(g))
    xs = [t.clone().requires_grad_(True) for t in targs]
    got = torch.autograd.grad(_port(kind, bwd_kernel)[1](*xs), xs,
                              torch.from_numpy(g))
    assert len(got) == len(want) == len(weight)
    for t, j, is_w in zip(got, want, weight):
        np.testing.assert_allclose(t.numpy().T if is_w else t.numpy(),
                                   np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_gradcheck_float64(kind):
    rng = np.random.default_rng(20)
    w, n = 8, 3
    rows = 2 * n

    def t(*shape, loc=0.0):
        return torch.from_numpy(loc + 0.3 * rng.normal(size=shape))

    ln = [t(w, loc=1.0), t(w)]
    qkv = [t(3 * w, w), t(3 * w)]
    tail = [t(w, w), t(w), t(w, loc=1.0), t(w), t(2 * w, w), t(2 * w),
            t(w, 2 * w), t(w)]
    args = {"ln_qkv": [t(rows, w)] + ln + qkv,
            "proj_mlp": [t(rows, w), t(rows, w)] + tail,
            "full_block": [t(rows, w)] + ln + qkv + tail,
            "ln_qkv_attn": [t(rows, w)] + ln + qkv}[kind]
    fn = {"ln_qkv": bk.fused_ln_qkv, "proj_mlp": bk.fused_proj_mlp,
          "full_block": lambda *a: bk.fused_block_full(*a, n, 2),
          "ln_qkv_attn": lambda *a: bk.fused_ln_qkv_attn(*a, n, 2)}[kind]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(fn, args)


def test_attention_reference_xla_matches_jax():
    from vit_marl_tpu.ops.attention_kernel import _attention_reference
    from vit_marl_tpu_torch.ops import attention_kernel as attn

    qkv = np.random.default_rng(4).normal(size=(5 * N, 3 * W)).astype(
        np.float32)
    want = _attention_reference(jnp.asarray(qkv), N, H)
    got = attn.attention_reference_xla(torch.from_numpy(qkv), N, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    jq, tq, _ = _pair(qkv, "bfloat16")
    want = _attention_reference(jq, N, H)
    got = attn.attention_reference_xla(tq, N, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL["bfloat16"])


@pytest.mark.parametrize("launch,args,match", [
    (bk._launch_ln_qkv, dict(W=96, K=288), "W=96"),
    (bk._launch_ln_qkv, dict(W=576, K=1728), "W=576"),
    (bk._launch_proj_mlp, dict(W=64, hidden=96), "hidden=96"),
    (bk._launch_full_block, dict(W=64, hidden=256, n=33, heads=2, rows=67),
     "67 rows do not split into images of 33 tokens"),
    (bk._launch_ln_qkv_attn, dict(W=256, n=11, heads=1), "D=256"),
    (bk._launch_ln_qkv_attn, dict(W=64, n=11, heads=16), "D=4")],
    ids=["width-not-64", "width-over-512", "hidden", "tokens", "head-wide",
         "head-narrow"])
def test_launchers_refuse_unsupported_shapes(launch, args, match):
    """Checked before anything reaches a card: a CUDA tensor of these
    shapes raises (``NotImplementedError``; ``ValueError`` for rows that
    do not split into images, at any number of tokens); the plain version
    is never taken instead.  (W over 512 never reaches a launcher
    through the wrappers: they take the composed route first, by
    shape.)"""
    Wd, n = args["W"], args.get("n", 1)
    rows = args.get("rows", 2 * n)
    x = torch.zeros(rows, Wd)
    v = torch.zeros(Wd)
    if launch is bk._launch_ln_qkv:
        call = lambda: launch(x, v, v, torch.zeros(args["K"], Wd),
                              torch.zeros(args["K"]))
    elif launch is bk._launch_proj_mlp:
        hd = args["hidden"]
        call = lambda: launch(x, x, torch.zeros(Wd, Wd), v, v, v,
                              torch.zeros(hd, Wd), torch.zeros(hd),
                              torch.zeros(Wd, hd), v)
    elif launch is bk._launch_full_block:
        hd = args["hidden"]
        call = lambda: launch(x, v, v, torch.zeros(3 * Wd, Wd),
                              torch.zeros(3 * Wd), torch.zeros(Wd, Wd), v, v,
                              v, torch.zeros(hd, Wd), torch.zeros(hd),
                              torch.zeros(Wd, hd), v, n, args["heads"])
    else:
        call = lambda: launch(x, v, v, torch.zeros(3 * Wd, Wd),
                              torch.zeros(3 * Wd), n, args["heads"])
    with pytest.raises(ValueError if "rows" in args else NotImplementedError,
                       match=match):
        call()


# --------------------------------------------------------------------------
# The tile plan of the bf16 tensor-core kernels (fused_proj_mlp,
# fused_block_full), computed on the host and checked by the C entry
# --------------------------------------------------------------------------

def _vit_small_plans():
    return (bk.wgmma_plan("fused_proj_mlp", 384, 1536),
            bk.wgmma_plan("fused_block_full", 384, 1536, 11, 6))


def _check_plan(plan, W, hidden, N=1, D=None):
    """What the C entry's plan_ok asks of a plan, and what the kernel's
    shared-memory regions need: in order, disjoint, within the limit."""
    assert plan["smem"] <= bk.SMEM_LIMIT
    assert plan["rows"] == bk.TC_ROWS and plan["stage_bytes"] == 64 * 128
    hc = plan["hc"]
    assert hc in (64, 128, 256) and hidden % hc == 0
    assert plan["hid_bufs"] == (1 if hc == 256 else 2)
    assert 1 <= plan["cluster"] <= 4
    tile = bk.TC_ROWS * W * 2
    ring = plan["stages"] * plan["stage_bytes"]
    assert plan["o_h"] >= ring and plan["o_h"] % 1024 == 0
    widest = max(W // 2, hc // 2)            # weight rows of a k-block
    if plan["kind"] == bk.KINDS["fused_proj_mlp"]:
        assert plan["o_hid"] >= plan["o_h"] + tile
        end = plan["o_hid"] + plan["hid_bufs"] * bk.TC_ROWS * hc * 2
    else:
        G, gd = plan["head_group"], plan["head_group"] * D
        assert 1 <= G <= W // D
        assert plan["slot"] == -(-gd // 16) * 16
        assert plan["gdp"] == -(-gd // 64) * 64 <= 192
        assert plan["ldq"] >= 3 * plan["slot"] and plan["ldq"] % 8 == 0
        assert 1 <= plan["attn_warps"] <= 8
        assert plan["o_qkv"] == plan["o_hid"] >= plan["o_h"] + tile
        assert plan["o_p"] >= plan["o_qkv"] + bk.TC_ROWS * plan["ldq"] * 2
        assert plan["o_at"] >= plan["o_p"] + (plan["attn_warps"] * N
                                              * (N + 1) * 4)
        assert plan["o_at"] >= (plan["o_hid"]
                                + plan["hid_bufs"] * bk.TC_ROWS * hc * 2)
        assert plan["o_at"] % 1024 == 0
        end = plan["o_at"] + -(-plan["slot"] // 64) * bk.TC_KB_BYTES
    n_bias = 4 * W + hidden + (3 * W if D else 0) + 256
    assert plan["o_bias"] >= end and plan["o_bias"] % 16 == 0
    assert plan["stages"] >= 2 * -(-widest // 64)
    assert plan["o_bar"] >= plan["o_bias"] + 4 * n_bias
    assert plan["smem"] >= plan["o_bar"] + 16 * plan["stages"] + 1024


@pytest.mark.parametrize("W", range(64, 513, 64))
def test_wgmma_plan_fits_every_accepted_shape(W):
    """Every bf16 shape the wrappers take has a plan that fits 232,448
    bytes of shared memory; kernel 7's tiles hold whole images, as many as
    fit in 64 rows."""
    for hidden in range(64, 2049, 64):
        _check_plan(bk.wgmma_plan("fused_proj_mlp", W, hidden), W, hidden)
        for D in range(8, 129, 8):
            if W % D:
                continue
            for N in range(1, 33):
                plan = bk.wgmma_plan("fused_block_full", W, hidden, N, W // D)
                _check_plan(plan, W, hidden, N, D)
                assert plan["images"] == bk.TC_ROWS // N
                assert plan["images"] * N <= bk.TC_ROWS


def test_wgmma_plan_feeds_128_rows_per_weight_fetch_at_vit_small():
    """A cluster shares each weight byte from L2 among at least 128 tile
    rows at ViT-Small's shapes (N=11, W=384, 6 heads, hidden 1,536):
    two CTAs of 64 rows, kernel 7's holding 5 whole images (55 tokens)."""
    proj_mlp, full = _vit_small_plans()
    for plan in (proj_mlp, full):
        assert plan["rows_per_fetch"] == plan["cluster"] * bk.TC_ROWS >= 128
    assert full["images"] == 5 and full["images"] * 11 <= bk.TC_ROWS


@pytest.mark.parametrize("W,N,D", [(384, 11, 64), (64, 13, 8), (512, 32, 128),
                                   (192, 17, 24), (320, 5, 40), (448, 1, 56)])
def test_wgmma_plan_covers_qkv_and_projection_columns_once(W, N, D):
    """Kernel 7's head groups, as the producer streams them and the
    epilogue stores them: every qkv column is computed by exactly one
    warpgroup from its own weight row, and every attention column enters
    the projection's k dimension exactly once (padding columns are
    zeros)."""
    plan = bk.wgmma_plan("fused_block_full", W, 4 * W, N, W // D)
    G, half = plan["head_group"], plan["gdp"] // 2
    H = W // D
    qkv_cols, proj_k = [], []
    for g0 in range(0, H, G):
        gd = min(G, H - g0) * D
        for part in range(3):
            for o in range(0, half, 64):       # products of <= 64 columns
                for wg in range(2):
                    row0 = part * W + g0 * D + o + wg * half   # producer
                    for c in range(min(64, half - o)):
                        wc = wg * half + o + c                   # epilogue
                        assert row0 + c == part * W + g0 * D + wc
                        if wc < gd:
                            qkv_cols.append(part * W + g0 * D + wc)
        at_kb = -(-plan["slot"] // 64)
        proj_k += [g0 * D + k for k in range(64 * at_kb) if k < gd]
    assert sorted(qkv_cols) == list(range(3 * W))
    assert sorted(proj_k) == list(range(W))


# --------------------------------------------------------------------------
# The tile plans of the bf16 tensor-core kernels 6a and 5 (fused_ln_qkv,
# fused_ln_qkv_attn)
# --------------------------------------------------------------------------

def _check_qkv_plan(plan, W, K, N=1, D=None):
    """What the C entry's plan_ok_qkv asks of a plan, and what the
    kernel's shared-memory regions need: in order, disjoint, within the
    limit."""
    assert plan["smem"] <= bk.SMEM_LIMIT
    assert plan["rows"] in (64, 128) and 1 <= plan["cluster"] <= 4
    nc = plan["nc"]
    assert nc in ((64,) if D else (64, 128))
    assert plan["stage_bytes"] == nc * 128 and plan["stages"] >= 3
    assert plan["o_h"] >= plan["stages"] * plan["stage_bytes"]
    assert plan["o_h"] % 1024 == 0
    end = plan["o_h"] + plan["rows"] * W * 2        # the A tiles
    if D is None:
        assert plan["o_qkv"] >= end and plan["o_qkv"] % 1024 == 0
        end = plan["o_qkv"] + plan["rows"] * nc * 2   # output staging
        n_bias = -(-K // nc) * nc + 2 * W
    else:
        G, DP = plan["head_group"], -(-D // 16) * 16
        np_ = 16 if N <= 16 else 32
        assert 1 <= G <= W // D
        assert plan["images"] == plan["rows"] // N >= 1
        assert plan["slot"] == G * DP
        assert plan["ldq"] >= 3 * plan["slot"] and plan["ldq"] % 8 == 0
        assert plan["qkv_rows"] >= max(plan["rows"],
                                       (plan["images"] - 1) * N + np_)
        assert plan["o_qkv"] >= end and plan["o_qkv"] % 16 == 0
        end = plan["o_qkv"] + plan["qkv_rows"] * plan["ldq"] * 2
        n_bias = 5 * W
    assert plan["o_bias"] >= end and plan["o_bias"] % 16 == 0
    assert plan["o_bar"] >= plan["o_bias"] + 4 * n_bias
    assert plan["smem"] >= plan["o_bar"] + 16 * plan["stages"] + 16 + 1024


def _qkv_chunks(plan, W, K, H=1, D=None):
    """The chunks of one tile as the producer streams them and the
    epilogue stores them (``Chunks`` in fused_block.cu): (first weight
    row, [(qkv column, tile column of its part and head), ...])."""
    nc = plan["nc"]
    if D is None:
        return [(c0, [(c0 + c, c0 + c) for c in range(nc) if c0 + c < K])
                for c0 in range(0, K, nc)]
    G, DP = plan["head_group"], -(-D // 16) * 16
    out = []
    for g0 in range(0, H, G):
        gd = min(G, H - g0) * D
        for part in range(3):
            for o in range(0, gd, 64):
                row = part * W + g0 * D + o
                cols = [(row + c, part * plan["slot"] + (o + c) // D * DP
                         + (o + c) % D) for c in range(nc) if o + c < gd]
                out.append((row, cols))
    return out


@pytest.mark.parametrize("W", range(64, 513, 64))
def test_qkv_wgmma_plans_fit_every_accepted_shape(W):
    """Kernels 6a and 5 have a plan at every bf16 shape the wrappers take
    (K a multiple of 64 up to 2,048; N <= 32; D a multiple of 8 up to
    128) that fits 232,448 bytes; 6a's chunks cover each of the K output
    columns once; 5's tiles hold whole images, and its chunks compute
    each qkv column once, from its own weight row, into its own place in
    the head group's tile."""
    for K in range(64, 2049, 64):
        plan = bk.wgmma_plan("fused_ln_qkv", W, K)
        _check_qkv_plan(plan, W, K)
        cols = [c for row, cc in _qkv_chunks(plan, W, K) for c, _ in cc]
        assert cols == list(range(K))
    for D in range(8, 129, 8):
        if W % D:
            continue
        H = W // D
        for N in range(1, 33):
            plan = bk.wgmma_plan("fused_ln_qkv_attn", W, 0, N, H)
            _check_qkv_plan(plan, W, 3 * W, N, D)
            seen = []
            for row, cc in _qkv_chunks(plan, W, 3 * W, H, D):
                for i, (c, at) in enumerate(cc):
                    assert c == row + i   # the weight row of its column
                    assert at < 3 * plan["slot"]
                seen += [c for c, _ in cc]
            assert sorted(seen) == list(range(3 * W))


def test_qkv_wgmma_plans_at_vit_small():
    """At ViT-Small's shapes each weight byte read from L2 feeds 256 tile
    rows (two CTAs of 128 rows, each warpgroup's 64 rows off one ring
    stage); 6a takes 128 columns a chunk, 5 holds 11 whole images (121
    rows) and a head a group."""
    qkv = bk.wgmma_plan("fused_ln_qkv", 384, 1152)
    attn = bk.wgmma_plan("fused_ln_qkv_attn", 384, 0, 11, 6)
    for plan in (qkv, attn):
        assert plan["rows"] == 128 and plan["rows_per_fetch"] == 256
        assert plan["stages"] >= bk.TC_MIN_STAGES
    assert qkv["nc"] == 128
    assert attn["images"] == 11 and attn["head_group"] == 1


def _mma_attention(qkv, n_tokens, heads):
    """The tensor-core attention of kernel 5 in torch: bf16 q, k, v
    multiplied exactly into float32 sums, ``scale`` on the float32
    logits, the float32 softmax P split into bf16 hi + lo for P v, the
    output rounded once to bf16."""
    rows, w3 = qkv.shape
    D = w3 // 3 // heads
    x = qkv.float().reshape(rows // n_tokens, n_tokens, 3, heads, D)
    q, k, v = x.permute(2, 0, 3, 1, 4)
    p = torch.softmax((q @ k.transpose(-1, -2)) * D ** -0.5, dim=-1)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    out = hi @ v + lo @ v
    return out.transpose(1, 2).reshape(rows, w3 // 3).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_ln_qkv_attn_mma_rounding_plan_within_block_tolerance(seed):
    """Kernel 5's rounding on the bf16 route (LN1 rounded, float32
    products and bias, qkv rounded to bf16, then the tensor-core
    attention with P as hi + lo) stays within the card's bf16 tolerance
    (``chip_smoke.py::block_tol``: rtol 1.6e-2, two ulps of the output's
    largest magnitude) of the JAX Pallas kernel in interpret mode and of
    the plain version."""
    jargs, targs, _ = _inputs("ln_qkv_attn", "bfloat16", seed=40 + seed)
    want_jax = np.asarray(_jax_fn("ln_qkv_attn")(*jargs), np.float32)
    got = _mma_attention(bk.ln_qkv_reference(*targs), N, H).float()
    want_plain = bk.ln_qkv_attn_reference(*targs, N, H).float()
    for want in (torch.from_numpy(want_jax), want_plain):
        m = float(want.abs().max())
        atol = 2 * 2.0 ** (np.floor(np.log2(m)) - 7)
        torch.testing.assert_close(got, want, rtol=1.6e-2, atol=atol)


# --------------------------------------------------------------------------
# The composed route: shapes past the JAX package's width guards
# --------------------------------------------------------------------------

NAMES = {"ln_qkv": "fused_ln_qkv", "proj_mlp": "fused_proj_mlp",
         "full_block": "fused_block_full", "ln_qkv_attn": "fused_ln_qkv_attn"}


class _KernelTaken(Exception):
    pass


def _jax_takes_kernel(kind, width, hidden, monkeypatch):
    """Whether the JAX function reaches ``pl.pallas_call`` (interpret
    mode, rows aligned to every row block) at this width and hidden
    width (``fused_ln_qkv``: its output width); traced, not run."""
    def kernel(*a, **k):
        raise _KernelTaken

    monkeypatch.setattr(jbk.pl, "pallas_call", kernel)
    rows, heads = 16 * 64 * N, width // 64
    f32 = jnp.float32
    x = jax.ShapeDtypeStruct((rows, width), f32)
    v = jax.ShapeDtypeStruct((width,), f32)

    def m(a, b):
        return jax.ShapeDtypeStruct((a, b), f32)

    def vec(a):
        return jax.ShapeDtypeStruct((a,), f32)

    tail = (m(width, width), v, v, v, m(width, hidden), vec(hidden),
            m(hidden, width), v)
    calls = {
        "ln_qkv": lambda: jax.eval_shape(
            lambda *a: jbk._ln_qkv_impl(*a, True), x, v, v,
            m(width, hidden), vec(hidden)),
        "proj_mlp": lambda: jax.eval_shape(
            lambda *a: jbk._proj_mlp_impl(*a, True), x, x, *tail),
        "full_block": lambda: jax.eval_shape(
            lambda *a: jbk._full_block_impl(*a, N, heads, 64, True), x, v,
            v, m(width, 3 * width), vec(3 * width), *tail),
        "ln_qkv_attn": lambda: jax.eval_shape(
            lambda *a: jbk._ln_qkv_attn_impl(*a, N, heads, 64, True), x, v,
            v, m(width, 3 * width), vec(3 * width))}
    try:
        calls[kind]()
    except _KernelTaken:
        return True
    return False


@pytest.mark.parametrize("hidden", [1536, 2048, 2304, 3072])
@pytest.mark.parametrize("width", [384, 512, 576, 768])
@pytest.mark.parametrize("kind", KINDS)
def test_route_predicate_matches_jax_guards(kind, width, hidden,
                                            monkeypatch):
    """``fits_kernel`` is true exactly where the JAX function takes its
    Pallas kernel: W up to 512, and the LN+QKV output or the MLP hidden
    up to 2048 (``fused_ln_qkv_attn``: W alone)."""
    want = _jax_takes_kernel(kind, width, hidden, monkeypatch)
    assert bk.fits_kernel(NAMES[kind], width, hidden) == want
    assert want == (width <= 512 and (kind == "ln_qkv_attn"
                                      or hidden <= 2048))


WIDE_W, WIDE_H = 768, 12     # ViT-Base


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_composed_route_matches_jax_reference(kind, dtype):
    """At ViT-Base's width (W=768, hidden 3,072, 12 heads) each wrapper
    takes the composed route, counted in ``.launches_composed`` and not
    in ``.launches``, and matches the JAX function, which takes its XLA
    reference there, within this file's plain-version tolerances (the
    same numerics; sums in another order, and bf16 elementwise ops that
    round once where XLA may round more often)."""
    rows = 3 * N
    jargs, targs, _ = _inputs(kind, dtype, seed=50 + KINDS.index(kind),
                              W=WIDE_W, rows=rows, scale=WIDE_W ** -0.5,
                              w2_scale=WIDE_W ** -0.5 / 2)
    jfn = {"ln_qkv": lambda *a: jbk.fused_ln_qkv(*a),
           "proj_mlp": lambda *a: jbk.fused_proj_mlp(*a),
           "full_block": lambda *a: jbk.fused_block_full(*a, N, WIDE_H),
           "ln_qkv_attn": lambda *a: jbk.fused_ln_qkv_attn(
               *a, N, WIDE_H)}[kind]
    fn = getattr(bk, NAMES[kind])
    wrapper = {"full_block": lambda *a: fn(*a, N, WIDE_H),
               "ln_qkv_attn": lambda *a: fn(*a, N, WIDE_H)}.get(kind, fn)
    before = (fn.launches, fn.launches_composed)
    got = wrapper(*targs)
    assert (fn.launches, fn.launches_composed) == (before[0], before[1] + 1)
    want = torch.from_numpy(np.array(jfn(*jargs), np.float32))
    assert got.dtype == DTYPES[dtype][1]
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("mode", ["fused_block", "fused_block_full",
                                  "attn_ln_fold"])
def test_vit_base_encoder_in_fused_modes_matches_flax(mode):
    """``VIT_PRESET=base`` (W=768, 12 heads, depth cut to 2) in each fused
    mode against the flax encoder in float32 within 1e-5, forward and
    weight gradients, every fused call on the composed route (counted),
    none on a kernel."""
    import dataclasses

    from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
    from vit_marl_tpu.models.vit import ViTEncoder as JViTEncoder
    from vit_marl_tpu_torch.models import vit as tvit
    from vit_marl_tpu_torch.models.bridge import vit_encoder_state_dict

    kw = {mode: True, "depth": 2, "compute_dtype": "float32"}
    jc = dataclasses.replace(J_PRESETS["base"], **kw)
    tc = dataclasses.replace(tvit.VIT_PRESETS["base"], **kw)
    img = np.random.default_rng(7).normal(size=(2, 3, 10, 3, 2)).astype(
        np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(7),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, 10)
    enc.load_state_dict(vit_encoder_state_dict(params["params"]),
                        strict=True)
    fns = {"fused_block": (bk.fused_ln_qkv, bk.fused_proj_mlp),
           "fused_block_full": (bk.fused_block_full,),
           "attn_ln_fold": (bk.fused_ln_qkv_attn,)}[mode]
    counts = [(f.launches, f.launches_composed) for f in fns]
    w = (np.random.default_rng(8).normal(size=(2, 3, 768)) / 32).astype(
        np.float32)
    out = enc(torch.from_numpy(img))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jenc.apply(params, jnp.asarray(img))), rtol=1e-5, atol=1e-5)
    # remat: each block's forward runs again in the backward
    assert [(f.launches, f.launches_composed) for f in fns] == [
        (n, c + 2 * 2) for n, c in counts]
    jgrads = vit_encoder_state_dict(jax.device_get(jax.grad(
        lambda p: jnp.sum(jenc.apply(p, jnp.asarray(img))
                          * jnp.asarray(w)))(params))["params"])
    for k, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
