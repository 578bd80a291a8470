"""The port's ViT encoder, ViT actor-critic and SquashedNormal against the
JAX package's, on identical weights.

The flax parameter tree goes through ``models/bridge.py`` into the torch
module; the same numpy inputs (T=4 steps, B=6 actors, resets, a non-zero
initial carry, a ``(10, 3, 2)`` book image and 28 flat features) go
through both, at the micro preset (W=64, depth 2, H=2).  With
``compute_dtype="float32"`` embedding, hidden state, value, mean and
log-probs agree within 1e-5.  At the default bf16 they agree within 2e-2:
the two frameworks round to bf16 at other points (bias adds, GELU) and
the errors of two blocks add up.  The port's attention keeps P in float32
where the JAX package's XLA path rounds it to bf16; that is inside the
same tolerance.  The encoder's own output is the final LayerNorm of the
bf16 residual stream, unit-scale, where one bf16 ulp is up to 1.6e-2: it
agrees within 3e-2 absolute (2e-2 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.models.distributions import SquashedNormal as JSquashed
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
from vit_marl_tpu.models.vit import ViTActorCriticRNN as JViTActorCriticRNN
from vit_marl_tpu.models.vit import ViTEncoder as JViTEncoder
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.bridge import (
    flax_to_state_dict,
    vit_encoder_state_dict,
)
from vit_marl_tpu_torch.models.distributions import SquashedNormal

T, B, OBS, LEVELS, ACT, H = 4, 6, 28, 10, 3, 64
LOW = np.array([-1.0, 0.0, 0.0], np.float32)
HIGH = np.array([3.0, 1.0, 1.0], np.float32)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ENCODER_TOL = {"float32": TOL["float32"],
               "bfloat16": dict(rtol=2e-2, atol=3e-2)}


def _cfgs(dtype, **kw):
    return (dataclasses.replace(J_PRESETS["micro"], compute_dtype=dtype,
                                **kw),
            dataclasses.replace(tvit.VIT_PRESETS["micro"],
                                compute_dtype=dtype, **kw))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    obs = {"obs": rng.normal(size=(T, B, OBS)).astype(np.float32),
           "vision_obs": rng.normal(size=(T, B, LEVELS, 3, 2)).astype(
               np.float32)}
    dones = rng.random((T, B)) < 0.3
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    return obs, dones, h0


def _jobs(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}


def _tobs(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def _pair(dtype, seed):
    jc, tc = _cfgs(dtype)
    jnet = JViTActorCriticRNN(action_dim=ACT, vit=jc, continuous=True,
                              action_low=jnp.asarray(LOW),
                              action_high=jnp.asarray(HIGH))
    obs, dones, _ = _inputs(seed)
    params = jnet.init(jax.random.PRNGKey(seed),
                       JScannedGRU.initialize_carry(B, H),
                       (_jobs(obs), jnp.asarray(dones)))
    params = jax.tree.map(np.asarray, jax.device_get(params))
    # a non-zero log_std, so the continuous head is fully exercised
    params["params"]["log_std"] = np.array([-0.3, 0.2, -1.1], np.float32)
    net = tvit.ViTActorCriticRNN(OBS, LEVELS, ACT, tc,
                                 action_low=torch.from_numpy(LOW),
                                 action_high=torch.from_numpy(HIGH))
    net.load_state_dict(flax_to_state_dict(params), strict=True)
    return jnet, params, net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_flax(dtype):
    jc, tc = _cfgs(dtype)
    img = np.random.default_rng(0).normal(size=(T, B, LEVELS, 3, 2)).astype(
        np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, LEVELS)
    sd = vit_encoder_state_dict(params["params"])
    enc.load_state_dict(sd, strict=True)
    want = jenc.apply(params, jnp.asarray(img))
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    assert got.shape == (T, B, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **ENCODER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_actor_critic_matches_flax(dtype):
    jnet, params, net = _pair(dtype, 1)
    obs, dones, h0 = _inputs(1)
    jh, jpi, jv = jnet.apply(params, jnp.asarray(h0),
                             (_jobs(obs), jnp.asarray(dones)))
    acts = LOW + (HIGH - LOW) * np.random.default_rng(2).random(
        (T, B, ACT)).astype(np.float32)
    with torch.no_grad():
        th, tpi, tv = net(torch.from_numpy(h0), _tobs(obs),
                          torch.from_numpy(dones))
        logp = tpi.log_prob(torch.from_numpy(acts))
        ent = tpi.entropy()
    tol = TOL[dtype]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(tpi.mean.numpy(), np.asarray(jpi.mean), **tol)
    np.testing.assert_allclose(
        logp.numpy(), np.asarray(jpi.log_prob(jnp.asarray(acts))), **tol)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jpi.entropy()), **tol)


def test_remat_gives_equal_outputs_and_gradients():
    _, params, net = _pair("float32", 3)
    tc = dataclasses.replace(net.vit.cfg, remat=False)
    plain = tvit.ViTActorCriticRNN(OBS, LEVELS, ACT, tc,
                                   action_low=torch.from_numpy(LOW),
                                   action_high=torch.from_numpy(HIGH))
    plain.load_state_dict(net.state_dict())
    obs, dones, h0 = _inputs(3)
    acts = torch.from_numpy(LOW + (HIGH - LOW) * np.random.default_rng(
        4).random((T, B, ACT)).astype(np.float32))
    outs, grads = [], []
    for m in (net, plain):
        m.zero_grad()
        _, pi, v = m(torch.from_numpy(h0), _tobs(obs),
                     torch.from_numpy(dones))
        (pi.log_prob(acts).sum() + v.square().sum()).backward()
        outs.append(v.detach())
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    assert net.vit.cfg.remat and not plain.vit.cfg.remat
    assert torch.equal(outs[0], outs[1])
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0)
    assert grads[0]["vit.blocks.0.attn.qkv.weight"].abs().max() > 0


def test_squashed_normal_matches_jax():
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(T, B, ACT)).astype(np.float32)
    log_std = np.array([-0.5, 0.1, -1.2], np.float32)
    jd = JSquashed(jnp.asarray(mean), jnp.asarray(log_std),
                   jnp.asarray(LOW), jnp.asarray(HIGH))
    td = SquashedNormal(torch.from_numpy(mean), torch.from_numpy(log_std),
                        torch.from_numpy(LOW), torch.from_numpy(HIGH))
    key = jax.random.PRNGKey(7)
    want = jd.sample(key)
    noise = jax.random.normal(key, mean.shape)      # the draws sample() makes
    got = td.sample(noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # in-range values, both bounds (clipped to +-(1 - 1e-6)) and the samples
    vals = np.concatenate([
        LOW + (HIGH - LOW) * rng.random((T, B, ACT)).astype(np.float32),
        np.broadcast_to(LOW, (1, B, ACT)), np.broadcast_to(HIGH, (1, B, ACT)),
        np.asarray(want)])
    jl = np.asarray(jd.log_prob(jnp.asarray(vals[-T:])))
    tl = td.log_prob(torch.from_numpy(vals[-T:].copy())).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-5)
    for part in (vals[:T], vals[T:T + 2]):
        jd2 = JSquashed(jnp.asarray(mean[:len(part)]), jnp.asarray(log_std),
                        jnp.asarray(LOW), jnp.asarray(HIGH))
        td2 = SquashedNormal(torch.from_numpy(mean[:len(part)]),
                             torch.from_numpy(log_std),
                             torch.from_numpy(LOW), torch.from_numpy(HIGH))
        np.testing.assert_allclose(
            td2.log_prob(torch.from_numpy(part.copy())).numpy(),
            np.asarray(jd2.log_prob(jnp.asarray(part))), rtol=1e-6,
            atol=1e-5)
    np.testing.assert_allclose(td.entropy().numpy(),
                               np.asarray(jd.entropy()), rtol=1e-6)
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()),
                               rtol=1e-6, atol=1e-6)


# attn_ln_fold without rows_2d is refused, as in the JAX package; every
# other mode, the fused kernels' included, builds at 41 tokens and matches
# flax there (tests/test_torch_long_tokens.py, tests/test_torch_networks.py)
@pytest.mark.parametrize("mode", [
    dict(rows_2d=False, attn_ln_fold=True),
    dict(fused_block_full=True), dict(attn_ln_fold=True),
    dict(rows_2d=False, fused_block_full=True),
    dict(attn_ln_fold=True, attn_bwd_kernel=False),
    dict(fused_block_full=True, attn_kernel=False)])
def test_modes_not_ported_raise(mode):
    jc, tc = _cfgs("float32", **mode)
    if not tc.rows_2d and tc.attn_ln_fold:
        with pytest.raises(ValueError, match="rows_2d"):
            tvit.ViTEncoder(tc, LEVELS)
        return
    levels = 40
    img = np.random.default_rng(7).normal(size=(2, levels, 3, 2)).astype(
        np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(7),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, levels)
    enc.load_state_dict(vit_encoder_state_dict(params["params"]),
                        strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jenc.apply(params,
                                                     jnp.asarray(img))),
                               **ENCODER_TOL["float32"])


MODES = {"fused_block": dict(fused_block=True),
         "fused_block_full": dict(fused_block_full=True),
         "attn_ln_fold": dict(attn_ln_fold=True),
         "xla_attention": dict(attn_kernel=False),
         "xla_attention_bwd": dict(attn_bwd_kernel=False)}


def _encoder_pair(dtype, mode, seed):
    jc, tc = _cfgs(dtype, **MODES[mode])
    img = np.random.default_rng(seed).normal(
        size=(T, B, LEVELS, 3, 2)).astype(np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, LEVELS)
    enc.load_state_dict(vit_encoder_state_dict(params["params"]),
                        strict=True)
    return jenc, params, enc, img


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_modes_match_flax(mode, dtype):
    """Each block mode on weights bridged from its own flax tree (the
    fused-family tree for the fused modes); same tolerances as above."""
    jenc, params, enc, img = _encoder_pair(dtype, mode, 0)
    if mode in ("fused_block", "fused_block_full", "attn_ln_fold"):
        assert "qkv_kernel" in params["params"]["block0"]
    want = jenc.apply(params, jnp.asarray(img))
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    assert got.shape == (T, B, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **ENCODER_TOL[dtype])


@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_mode_gradients_match_flax(mode):
    """float32: the gradient of a loss of the embedding with respect to
    every parameter, through remat and the fused functions' backwards,
    against jax.grad of the flax encoder (whose fused calls on the CPU
    differentiate the same compositions), within 1e-5."""
    jenc, params, enc, img = _encoder_pair("float32", mode, 1)
    # a weight of scale 1/32 keeps the summed gradients near unit scale
    w = (np.random.default_rng(2).normal(size=(T, B, 64)) / 32).astype(
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_actor_critic_modes_match_flax(mode, dtype):
    jc, tc = _cfgs(dtype, **MODES[mode])
    jnet = JViTActorCriticRNN(action_dim=ACT, vit=jc, continuous=True,
                              action_low=jnp.asarray(LOW),
                              action_high=jnp.asarray(HIGH))
    obs, dones, h0 = _inputs(4)
    params = jax.device_get(jnet.init(
        jax.random.PRNGKey(4), JScannedGRU.initialize_carry(B, H),
        (_jobs(obs), jnp.asarray(dones))))
    net = tvit.ViTActorCriticRNN(OBS, LEVELS, ACT, tc,
                                 action_low=torch.from_numpy(LOW),
                                 action_high=torch.from_numpy(HIGH))
    net.load_state_dict(flax_to_state_dict(params), strict=True)
    jh, jpi, jv = jnet.apply(params, jnp.asarray(h0),
                             (_jobs(obs), jnp.asarray(dones)))
    with torch.no_grad():
        th, tpi, tv = net(torch.from_numpy(h0), _tobs(obs),
                          torch.from_numpy(dones))
    tol = TOL[dtype]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(tpi.mean.numpy(), np.asarray(jpi.mean), **tol)


def test_fused_modes_keep_the_parameter_layout():
    """One state_dict serves every mode: the fused-family tree and the
    unfused tree of the same values bridge to equal tensors."""
    from vit_marl_tpu.models.convert import convert_vit_params

    _, params, enc, _ = _encoder_pair("float32", "fused_block_full", 5)
    unfused = convert_vit_params(params, to_fused=False)
    a = vit_encoder_state_dict(params["params"])
    b = vit_encoder_state_dict(unfused["params"])
    assert set(a) == set(b) == set(enc.state_dict())
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_more_than_32_tokens_raise():
    """33 tokens build in every mode: the fused kernels of
    fused_block_full and attn_ln_fold take the image on their route past
    32 tokens, the others on dot_product_attention."""
    for mode in [{}] + [dict(v) for v in MODES.values()]:
        _, tc = _cfgs("float32", **mode)
        enc = tvit.ViTEncoder(tc, 32)
        with torch.no_grad():
            y = enc(torch.zeros((2, 32, 3, 2)))
        assert y.shape == (2, 64) and torch.isfinite(y).all(), mode
