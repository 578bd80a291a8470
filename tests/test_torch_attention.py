"""The port's short-sequence attention against the JAX package's kernels.

The plain PyTorch forward and backward (``vit_marl_tpu_torch/ops/
attention_kernel.py``) take the same numpy-made qkv rows as the Pallas
kernels ``fused_short_attention`` / ``_bwd_kernel_call`` in interpret mode
(a small ``env_block``, as ``tests/test_attention_kernel.py`` runs them).
float32 agrees within 1e-5 relative; bf16 inputs within one bf16 ulp (the
interpret kernel computes in float32 too and rounds once).  The backward
also matches ``jax.vjp`` of ``_attention_reference`` in float32, and the
autograd wrapper passes ``gradcheck`` in float64 on the CPU.  An emulation
of the bf16 CUDA route's rounding plan (bf16 operands, float32 products,
P and dS split into bf16 hi + lo) meets the same bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.ops.attention_kernel import (
    _attention_reference,
    _bwd_kernel_call,
    fused_short_attention,
)
from vit_marl_tpu_torch.ops import attention_kernel as attn

B, EB = 8, 4
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=8e-3, atol=1e-3)     # one bf16 ulp of the magnitude
SHAPES = [(5, 2, 16), (11, 2, 32), (11, 6, 64)]   # (N, H, D)


def _inputs(N, H, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B * N, 3 * H * D)).astype(np.float32)
    g = rng.normal(size=(B * N, H * D)).astype(np.float32)
    return qkv, g


def _bf16(x):
    """float32 numpy -> (bf16 jax array, bf16 torch tensor) of one value."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("N,H,D", SHAPES)
def test_forward_matches_pallas_kernel_f32(N, H, D):
    qkv, _ = _inputs(N, H, D, N + H)
    want = fused_short_attention(jnp.asarray(qkv), N, H, env_block=EB,
                                 interpret=True)
    got = attn.short_attention_reference(torch.from_numpy(qkv), N, H)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("N,H,D", SHAPES)
def test_forward_matches_pallas_kernel_bf16(N, H, D):
    qkv, _ = _inputs(N, H, D, N + H + 1)
    jq, tq = _bf16(qkv)
    want = fused_short_attention(jq, N, H, env_block=EB, interpret=True)
    got = attn.short_attention_reference(tq, N, H)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("N,H,D", SHAPES)
def test_backward_matches_pallas_kernel_and_vjp(N, H, D):
    qkv, g = _inputs(N, H, D, N + H + 2)
    got = attn.short_attention_bwd_reference(
        torch.from_numpy(qkv), torch.from_numpy(g), N, H).numpy()
    kern = _bwd_kernel_call(jnp.asarray(qkv), jnp.asarray(g), N, H, EB,
                            True)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    _, vjp = jax.vjp(lambda x: _attention_reference(x, N, H),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_backward_matches_pallas_kernel_bf16():
    N, H, D = 11, 6, 64
    qkv, g = _inputs(N, H, D, 7)
    (jq, tq), (jg, tg) = _bf16(qkv), _bf16(g)
    want = _bwd_kernel_call(jq, jg, N, H, EB, True)
    got = attn.short_attention_bwd_reference(tq, tg, N, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def _split_bf16(x):
    """float32 -> (hi, lo): hi = bf16(x), lo = bf16(x - hi), as float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mma_plan(qkv, g, N, H):
    """The bf16 CUDA route's arithmetic in torch: bf16 operands, float32
    products and sums, ``scale`` applied after each product, P and dS
    split into bf16 hi + lo where they enter a product.  Returns the
    forward rows and the qkv cotangent, rounded once to bf16."""
    q, k, v, scale = attn._split(qkv, N, H)        # bf16 values, float32
    B = q.shape[0]
    D = q.shape[-1]
    gh = g.float().reshape(B, N, H, D).transpose(1, 2)
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    p_hi, p_lo = _split_bf16(p)
    out = p_hi @ v + p_lo @ v
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    s_hi, s_lo = _split_bf16(ds)
    dq = (s_hi @ k + s_lo @ k) * scale
    dk = (s_hi.transpose(-1, -2) @ q + s_lo.transpose(-1, -2) @ q) * scale
    dv = p_hi.transpose(-1, -2) @ gh + p_lo.transpose(-1, -2) @ gh
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return (out.transpose(1, 2).reshape(B * N, H * D).to(torch.bfloat16),
            dqkv.reshape(B * N, 3 * H * D).to(torch.bfloat16))


@pytest.mark.parametrize("N,H,D", [(11, 6, 64), (32, 2, 128), (5, 2, 24)])
def test_mma_rounding_plan_within_bf16_tolerance(N, H, D):
    """The tensor-core route's rounding plan meets the bf16 tolerance
    against the plain versions and the Pallas kernels (interpret mode)."""
    qkv, g = _inputs(N, H, D, 11 * N + D)
    (jq, tq), (jg, tg) = _bf16(qkv), _bf16(g)
    out, dqkv = _mma_plan(tq, tg, N, H)
    for got, want in [
            (out, attn.short_attention_reference(tq, N, H)),
            (out, fused_short_attention(jq, N, H, env_block=EB,
                                        interpret=True)),
            (dqkv, attn.short_attention_bwd_reference(tq, tg, N, H)),
            (dqkv, _bwd_kernel_call(jq, jg, N, H, EB, True))]:
        if isinstance(want, torch.Tensor):
            want = want.float()
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)


def test_wrapper_gradcheck_float64_on_cpu():
    N, H, D = 5, 2, 8
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3 * N, 3 * H * D))).requires_grad_(True)
    before = (attn.short_attention.launches_fwd,
              attn.short_attention.launches_bwd)
    assert torch.autograd.gradcheck(
        lambda t: attn.short_attention(t, N, H), (x,))
    # the CPU path runs the plain versions: no kernel launch is counted
    assert (attn.short_attention.launches_fwd,
            attn.short_attention.launches_bwd) == before


def test_wrapper_without_grad_runs_the_plain_forward():
    N, H, D = 11, 2, 16
    qkv, _ = _inputs(N, H, D, 10)
    x = torch.from_numpy(qkv).requires_grad_(True)
    want = attn.short_attention_reference(x.detach(), N, H)
    with torch.no_grad():
        out = attn.short_attention(x, N, H)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    out = attn.short_attention(x.detach(), N, H)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_wrapper_saves_qkv_and_runs_the_plain_backward_on_cpu():
    N, H, D = 11, 2, 16
    qkv, g = _inputs(N, H, D, 9)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = attn.short_attention(x, N, H)
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    np.testing.assert_array_equal(
        dx.numpy(), attn.short_attention_bwd_reference(
            x.detach(), torch.from_numpy(g), N, H).numpy())
    with pytest.raises(ValueError, match="does not split"):
        attn.short_attention(x[:-1], N, H)
