"""The networks and ViT layouts of the port's eleventh slice against the
JAX package's, on identical weights (through the flax bridge, loaded
with ``strict=True``) and the same numpy inputs.

- ``VisionAgentCNN`` and ``CNNActorCriticRNN`` (``network: cnn_gru``)
  against flax in float32 within rtol 1e-5 (atol 1e-5), with discrete
  and continuous heads; ``ActorCriticRNN`` with a ``Box`` head
  (continuous ``gru``) within the same;
- one PPO update of ``cnn_gru`` and of continuous ``gru`` through
  ``tests/test_torch_ppo.py::_check_update`` (weights within 1e-4
  relative).  The CNN's ``Dense(128)`` holds 122,880 weights, some of
  whose gradients are within float32 summation noise of 0; Adam
  normalises those into steps of noise, so its weights are held at
  atol 1e-5 (a hundredth of one step at lr 1e-3), after its loss
  gradient is held at 1e-6 of each tensor's largest entry;
- the ViT encoder with ``rows_2d=False`` (B, N, W tokens) at the micro
  preset in float32 and bf16, at 11 and at 41 tokens (``VISION_LEVELS``
  40: the ``dot_product_attention`` route), against flax within
  ``tests/test_torch_vit.py``'s tolerances; the route counts; the
  refusal of ``attn_ln_fold`` under ``rows_2d=False`` (``ValueError``,
  as the JAX package raises; the fused kernels past 32 tokens:
  ``tests/test_torch_vit.py::test_modes_not_ported_raise``);
- a CPU ``make_train`` of each network in a world whose execution agent
  has a ``Box`` space.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ppo import A, H, _behaviour_log_prob, _check_update, _trajectory
from test_torch_ppo import T as T_PPO
from test_torch_vit import ENCODER_TOL, _cfgs
from vit_marl_tpu.models.cnn import CNNActorCriticRNN as JCNNActorCriticRNN
from vit_marl_tpu.models.cnn import VisionAgentCNN as JVisionAgentCNN
from vit_marl_tpu.models.rnn import ActorCriticRNN as JActorCriticRNN
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.models.vit import ViTEncoder as JViTEncoder
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.bridge import (
    cnn_encoder_state_dict,
    flax_to_state_dict,
    vit_encoder_state_dict,
)
from vit_marl_tpu_torch.models.cnn import CNNActorCriticRNN, VisionAgentCNN
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN
from vit_marl_tpu_torch.ops import attention_kernel as attn
from vit_marl_tpu_torch.rl import ppo as tppo

T, B, OBS, LEVELS = 3, 5, 28, 10
LOW = np.array([-1.0, 0.0, 0.0], np.float32)
HIGH = np.array([3.0, 1.0, 1.0], np.float32)
F32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, levels=LEVELS, obs_dim=OBS):
    rng = np.random.default_rng(seed)
    obs = {"obs": rng.normal(size=(T, B, obs_dim)).astype(np.float32),
           "vision_obs": rng.normal(size=(T, B, levels, 3, 2)).astype(
               np.float32)}
    return obs, rng.random((T, B)) < 0.3, \
        rng.normal(size=(B, H)).astype(np.float32)


def _bounds(continuous):
    if continuous:
        return dict(continuous=True, action_low=jnp.asarray(LOW),
                    action_high=jnp.asarray(HIGH)), dict(
            action_low=torch.from_numpy(LOW),
            action_high=torch.from_numpy(HIGH))
    return {}, {}


def _compare_heads(jout, tout, continuous):
    (jh, jpi, jv), (th, tpi, tv) = jout, tout
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    if continuous:
        np.testing.assert_allclose(tpi.mean.numpy(), np.asarray(jpi.mean),
                                   **F32)
    else:
        np.testing.assert_allclose(tpi.logits.numpy(),
                                   np.asarray(jpi.logits), **F32)


@pytest.mark.parametrize("levels", [LEVELS, 40])
def test_cnn_encoder_matches_flax(levels):
    img = np.random.default_rng(levels).normal(
        size=(T, B, levels, 3, 2)).astype(np.float32)
    jenc = JVisionAgentCNN()
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0),
                                      jnp.asarray(img)))
    enc = VisionAgentCNN(levels)
    enc.load_state_dict(cnn_encoder_state_dict(params["params"]),
                        strict=True)
    want = jenc.apply(params, jnp.asarray(img))
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    assert got.shape == (T, B, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "box"])
def test_cnn_actor_critic_matches_flax(continuous):
    jkw, tkw = _bounds(continuous)
    act = 3 if continuous else 4
    jnet = JCNNActorCriticRNN(action_dim=act, **jkw)
    obs, dones, h0 = _inputs(1)
    jin = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(dones))
    params = jax.device_get(jnet.init(
        jax.random.PRNGKey(1), JScannedGRU.initialize_carry(B, H), jin))
    if continuous:
        params["params"]["log_std"] = np.array([-0.3, 0.2, -1.1],
                                               np.float32)
    net = CNNActorCriticRNN(OBS, LEVELS, act, **tkw)
    net.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        tout = net(torch.from_numpy(h0),
                   {k: torch.from_numpy(v) for k, v in obs.items()},
                   torch.from_numpy(dones))
    _compare_heads(jnet.apply(params, jnp.asarray(h0), jin), tout,
                   continuous)


def test_gru_box_head_matches_flax():
    jkw, tkw = _bounds(True)
    jnet = JActorCriticRNN(action_dim=3, **jkw)
    obs, dones, h0 = _inputs(2)
    x = obs["obs"]
    jin = (jnp.asarray(x), jnp.asarray(dones))
    params = jax.device_get(jnet.init(
        jax.random.PRNGKey(2), JScannedGRU.initialize_carry(B, H), jin))
    params["params"]["log_std"] = np.array([0.4, -0.7, 0.1], np.float32)
    net = ActorCriticRNN(OBS, 3, **tkw)
    net.load_state_dict(flax_to_state_dict(params), strict=True)
    assert net.continuous and "log_std" in net.state_dict()
    with torch.no_grad():
        tout = net(torch.from_numpy(h0), torch.from_numpy(x),
                   torch.from_numpy(dones))
    _compare_heads(jnet.apply(params, jnp.asarray(h0), jin), tout, True)
    act = np.clip(np.asarray(tout[1].mode()), LOW + 0.01, HIGH - 0.01)
    np.testing.assert_allclose(
        tout[1].log_prob(torch.from_numpy(act)).detach().numpy(),
        np.asarray(jnet.apply(params, jnp.asarray(h0), jin)[1].log_prob(
            jnp.asarray(act))), rtol=1e-5, atol=1e-4)


def _box_trajectory(seed, obs):
    tr = _trajectory(seed)
    rng = np.random.default_rng(seed + 100)
    tr["obs"] = obs
    tr["action"] = (LOW + (HIGH - LOW) * rng.random((T_PPO, A, 3))).astype(
        np.float32)
    return tr


def test_continuous_gru_ppo_update_matches_jax():
    jkw, tkw = _bounds(True)
    jnet = JActorCriticRNN(action_dim=3, **jkw)
    rng = np.random.default_rng(7)
    tr = _box_trajectory(7, rng.normal(size=(T_PPO, A, 10)).astype(
        np.float32))
    params = jnet.init(jax.random.PRNGKey(7),
                       JScannedGRU.initialize_carry(A, H),
                       (jnp.zeros((1, A, 10)), jnp.zeros((1, A), bool)))
    net = ActorCriticRNN(10, 3, **tkw)
    net.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                        strict=True)
    init_h = rng.normal(size=(A, H)).astype(np.float32)
    tr["log_prob"] = _behaviour_log_prob(net, init_h, tr)
    _check_update(jnet, params, net, tr, init_h)


def test_cnn_gru_ppo_update_matches_jax():
    from test_torch_ppo import _jtraj, _ttraj
    jnet = JCNNActorCriticRNN(action_dim=6)
    rng = np.random.default_rng(8)
    tr = _trajectory(8)
    tr["obs"] = {"obs": rng.normal(size=(T_PPO, A, OBS)).astype(np.float32),
                 "vision_obs": rng.normal(
                     size=(T_PPO, A, LEVELS, 3, 2)).astype(np.float32)}
    params = jnet.init(jax.random.PRNGKey(8),
                       JScannedGRU.initialize_carry(A, H),
                       (jax.tree.map(lambda v: jnp.asarray(v[:1]),
                                     tr["obs"]), jnp.zeros((1, A), bool)))
    net = CNNActorCriticRNN(OBS, LEVELS, 6)
    net.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                        strict=True)
    init_h = rng.normal(size=(A, H)).astype(np.float32)
    tr["log_prob"] = _behaviour_log_prob(net, init_h, tr)
    # the gradient of a loss of every output
    jt, tt = _jtraj(tr), _ttraj(tr)

    def loss(p):
        _, pi, v = jnet.apply(p, jnp.asarray(init_h), (jt.obs, jt.done))
        return (pi.log_prob(jt.action) * jt.reward).mean() + (v * v).mean()

    want = flax_to_state_dict(jax.device_get(jax.grad(loss)(params)))
    _, pi, v = net(torch.from_numpy(init_h), tt.obs, tt.done)
    ((pi.log_prob(tt.action) * tt.reward).mean() + (v * v).mean()).backward()
    for k, p in net.named_parameters():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
    net.zero_grad(set_to_none=True)
    _check_update(jnet, params, net, tr, init_h, atol=1e-5)


def _encoder_pair(dtype, levels, seed, **kw):
    jc, tc = _cfgs(dtype, **kw)
    img = np.random.default_rng(seed).normal(
        size=(T, B, levels, 3, 2)).astype(np.float32)
    jenc = JViTEncoder(jc)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(img)))
    enc = tvit.ViTEncoder(tc, levels)
    enc.load_state_dict(vit_encoder_state_dict(params["params"]),
                        strict=True)
    return jenc, params, enc, img


LAYOUTS = {"rows_3d": dict(rows_2d=False),
           "rows_3d_fused_block": dict(rows_2d=False, fused_block=True),
           "rows_3d_fused_block_full": dict(rows_2d=False,
                                            fused_block_full=True),
           "rows_2d": {}, "rows_2d_fused_block": dict(fused_block=True)}
# (layout, levels, dtype): the (B, N, W) layout in both dtypes at 11 and
# 41 tokens; its fused modes, and flat rows past 32 tokens (the default
# and fused_block; fused_block_full raises there: test_torch_vit.py::
# test_modes_not_ported_raise; flat rows at 11 tokens:
# test_torch_vit.py::test_encoder_modes_match_flax)
CASES = [("rows_3d", LEVELS, "float32"), ("rows_3d", LEVELS, "bfloat16"),
         ("rows_3d", 40, "float32"), ("rows_3d", 40, "bfloat16"),
         ("rows_3d_fused_block", LEVELS, "float32"),
         ("rows_3d_fused_block", 40, "float32"),
         ("rows_3d_fused_block_full", LEVELS, "float32"),
         ("rows_2d", 40, "float32"), ("rows_2d", 40, "bfloat16"),
         ("rows_2d_fused_block", 40, "float32")]


@pytest.mark.parametrize("layout,levels,dtype", CASES,
                         ids=[f"{a}-{b + 1}tok-{c}" for a, b, c in CASES])
def test_encoder_layouts_match_flax(layout, levels, dtype):
    """Each layout and mode that takes the image against flax; the
    attention's route counted: rank-3 tokens never on the kernels (on the
    CPU the wrapper's plain version counts no launch either way), 41
    tokens on ``dot_product_attention`` once a block."""
    kw = LAYOUTS[layout]
    jenc, params, enc, img = _encoder_pair(dtype, levels, levels, **kw)
    want = jenc.apply(params, jnp.asarray(img))
    calls0 = attn.dot_product_attention.calls
    fwd0 = attn.short_attention.launches_fwd
    with torch.no_grad():
        got = enc(torch.from_numpy(img))
    assert got.shape == (T, B, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **ENCODER_TOL[dtype])
    long_calls = attn.dot_product_attention.calls - calls0
    assert long_calls == (2 if levels == 40 else 0)     # depth 2
    assert attn.short_attention.launches_fwd == fwd0    # plain on the CPU


@pytest.mark.parametrize("layout", ["rows_3d", "rows_2d"])
def test_long_encoder_gradients_match_flax(layout):
    """float32 at 41 tokens: gradients through remat and autograd of
    ``dot_product_attention`` against ``jax.grad``, within 1e-5."""
    jenc, params, enc, img = _encoder_pair("float32", 40, 3,
                                           **LAYOUTS[layout])
    w = (np.random.default_rng(4).normal(size=(T, B, 64)) / 32).astype(
        np.float32)
    grads = jax.grad(lambda p: jnp.sum(
        jenc.apply(p, jnp.asarray(img)) * jnp.asarray(w)))(params)
    want = vit_encoder_state_dict(jax.device_get(grads)["params"])
    (enc(torch.from_numpy(img)) * torch.from_numpy(w)).sum().backward()
    for k, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_attn_ln_fold_needs_rows_2d_as_in_jax():
    jc, tc = _cfgs("float32", rows_2d=False, attn_ln_fold=True)
    img = jnp.zeros((B, LEVELS, 3, 2))
    with pytest.raises(ValueError, match="rows_2d") as jerr:
        JViTEncoder(jc).init(jax.random.PRNGKey(0), img)
    with pytest.raises(ValueError, match="rows_2d") as terr:
        tvit.ViTEncoder(tc, LEVELS)
    assert str(terr.value) == str(jerr.value)


def _box_world():
    """The 2-player world with a ``fixed_prices`` execution agent (a
    ``Box`` action) and a small synthetic day."""
    return tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(n_orders=64,
                               n_messages_per_synthetic_day=4000,
                               episode_time=2, start_resolution=5),
        agents=(tcfg.MarketMakingConfig(),
                tcfg.ExecutionConfig(action_space="fixed_prices",
                                     n_actions=4)))


@pytest.mark.parametrize("network", [("gru", "gru"), ("gru", "cnn_gru")],
                         ids=["gru_box", "cnn_gru"])
def test_make_train_trains_the_new_networks(network):
    """``make_train`` on the CPU: continuous ``gru`` (the execution
    agent's ``Box``), and ``cnn_gru`` on the vision world's dict
    observations."""
    ma = _box_world()
    if network[1] == "cnn_gru":
        ma = dataclasses.replace(ma, agents=(
            tcfg.MarketMakingConfig(),
            tcfg.ExecutionConfig(action_space="policy_blending",
                                 observation_space="execution_policy",
                                 reward_space="dual_ppo",
                                 use_vision_obs=True, task_size=500)))
    tc = tcfg.TrainConfig(num_envs=4, num_steps=4, update_epochs=1,
                          num_minibatches=2, total_timesteps=16,
                          network=network, log_backend="none")
    out = tppo.make_train(ma, tc, device="cpu")(seed=0)
    nets = out["networks"]
    assert nets[1].continuous
    if network[1] == "cnn_gru":
        assert isinstance(nets[1], CNNActorCriticRNN)
    m = out["metrics"][0]
    assert all(np.isfinite(v) for v in m.values())
    assert "EXE/action_std" in m or any(k.endswith("/action_std")
                                         for k in m)
