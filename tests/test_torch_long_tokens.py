"""The fused modes that attend inside their kernels past 32 tokens.

``fused_block_full`` (kernel 7) and ``attn_ln_fold`` (kernel 5) take
images of any number of tokens, as the JAX package's Pallas kernels do
(its guards ``full_block_ok`` / ``ln_qkv_attn_ok`` have no token bound).
The port's encoder in each of the two modes, at N = 33, 41 and 65 tokens
(32, 40 and 64 book levels and the CLS token), is held against the flax
encoder on the same weights, bridged through ``models/bridge.py``, and
the same numpy-seeded images, at the micro preset (W=64, depth 2, H=2):
forward in float32 within 1e-5 and in bf16 within the tolerance of
``tests/test_torch_vit.py`` (2e-2 relative, 3e-2 absolute: the final
LayerNorm of a bf16 residual stream), and the float32 gradient of a loss
of the embedding with respect to every parameter within 1e-5.  On the
CPU both sides run their plain compositions, as the JAX package's own
tests run its fused functions off a TPU.  The CUDA kernels of the route
past 32 tokens are checked against the same plain versions on the card
(``tests/test_torch_kernel_gpu.py``, ``chip_smoke.py`` phase 18).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
from vit_marl_tpu.models.vit import ViTEncoder as JViTEncoder
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.bridge import vit_encoder_state_dict
from vit_marl_tpu_torch.ops import attention_kernel as attn
from vit_marl_tpu_torch.ops import block_kernel as bk

B = 3
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
MODES = {"fused_block_full": dict(fused_block_full=True),
         "attn_ln_fold": dict(attn_ln_fold=True)}
LEVELS = (32, 40, 64)


def _encoders(mode, dtype, levels, seed):
    kw = dict(compute_dtype=dtype, **MODES[mode])
    jc = dataclasses.replace(J_PRESETS["micro"], **kw)
    tc = dataclasses.replace(tvit.VIT_PRESETS["micro"], **kw)
    img = np.random.default_rng(seed).normal(
        size=(B, levels, 3, 2)).astype(np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, levels)
    enc.load_state_dict(vit_encoder_state_dict(params["params"]),
                        strict=True)
    return jenc, params, enc, img


def _calls():
    fn = bk.fused_block_full, bk.fused_ln_qkv_attn
    return [f.launches + f.launches_composed for f in fn] + [
        attn.dot_product_attention.calls]


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_past_32_tokens_matches_flax(mode, dtype, levels):
    jenc, params, enc, img = _encoders(mode, dtype, levels, levels)
    want = jenc.apply(params, jnp.asarray(img))
    before = _calls()
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    # the CPU takes the plain versions: no kernel, no composed route, and
    # not the unfused attention past 32 tokens
    assert _calls() == before
    assert got.shape == (B, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_past_32_tokens_gradients_match_flax(mode, levels):
    """float32, a weight of scale 1/32 as in ``tests/test_torch_vit.py``,
    through remat and the fused functions' backwards
    (``attn_ln_fold`` past 32 tokens differentiates the XLA-form
    attention, as the JAX package's ``_ln_qkv_attn_bwd`` does where
    its attention kernel does not take the shape)."""
    jenc, params, enc, img = _encoders(mode, "float32", levels, levels + 1)
    w = (np.random.default_rng(levels).normal(size=(B, 64)) / 32).astype(
        np.float32)
    grads = jax.grad(lambda p: jnp.sum(
        jenc.apply(p, jnp.asarray(img)) * jnp.asarray(w)))(params)
    want = vit_encoder_state_dict(jax.device_get(grads)["params"])
    (enc(torch.from_numpy(img)) * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad for k, p in enc.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
