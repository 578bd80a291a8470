"""The execution ``simplest_case`` spaces of the port against the JAX
package: the worlds of ``configs/ippo_simplest_case.yaml`` and
``configs/ippo_vision_simplest.yaml``, the ViT actor-critic of the second
with its discrete head, and both configs' ``make_train``.

The worlds run at the small world of ``tests/test_torch_env.py`` (64 book
slots, a 4,000-message synthetic day, 2-second windows) with the
configs' agents; ``step_vec`` is compared over an episode boundary as
there.  The actor-critic is compared on identical weights carried across
by ``models/bridge.py``, at the micro preset in float32 (1e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
from vit_marl_tpu.models.vit import ViTActorCriticRNN as JViTActorCriticRNN
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env import spaces as tspaces
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.rl import ppo as tppo

from test_torch_env import WORLD, _run_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("ippo_simplest_case.yaml", "ippo_vision_simplest.yaml")


def _raw(name, **exe):
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["WORLD"].update({k.upper(): v for k, v in WORLD.items()})
    raw["AGENT_CONFIGS"]["Execution"].update(exe)
    return raw


def _worlds(raw):
    jma, _ = jcfg.make_config(raw)
    tma, _ = tcfg.make_config(raw)
    return JWorldEnv(jma), WorldEnv(tma, device="cpu")


@pytest.mark.parametrize("name,task_size", [(CONFIGS[0], 100),
                                            (CONFIGS[1], 15)],
                         ids=["simplest_case", "vision_simplest_capped"])
def test_simplest_step_vec_matches_jax(name, task_size):
    """At TASK_SIZE 15 an order of 10 soon exceeds the remainder, and the
    reference's cap (10 times the remainder at the far touch) takes over."""
    jenv, tenv = _worlds(_raw(name, TASK_SIZE=task_size))
    space = tenv.action_spaces[0]
    assert isinstance(space, tspaces.Discrete) and space.n == 3
    obs_space = tenv.observation_spaces[0]
    if name == "ippo_simplest_case.yaml":
        assert obs_space.shape == (3,)
    else:
        assert isinstance(obs_space, tspaces.Dict)
    _run_steps(jenv, tenv, 3)


def test_simplest_observation_reads_the_time_in_seconds():
    """The reference reads the time used as seconds against EPISODE_TIME
    even in fixed_steps episodes: ``percent_time_remaining`` goes negative
    once a window runs longer than EPISODE_TIME seconds."""
    _, tenv = _worlds(_raw(CONFIGS[0], NORMALIZE=False))
    gen = torch.Generator().manual_seed(0)
    params = tenv.default_params
    _, state = tenv.reset(tenv.draw_reset(4, gen), params)
    world = state.world.replace(time=state.world.init_time + torch.tensor(
        [3 * tenv.wcfg.episode_time, 0], dtype=torch.int32))
    obs = tenv.agent_types[0].get_observation(world, state.agents[0])
    np.testing.assert_allclose(obs[..., 2].numpy(), -2.0)


def test_vision_simplest_actor_critic_matches_flax():
    """``vit_gru`` with the discrete head of ``ippo_vision_simplest.yaml``
    (3 actions, 28 flat features and the (10, 3, 2) book image), at the
    micro preset in float32, on the flax weights."""
    T, B, OBS, LEVELS, ACT, H = 4, 6, 28, 10, 3, 64
    jc = dataclasses.replace(J_PRESETS["micro"], compute_dtype="float32")
    tc = dataclasses.replace(tvit.VIT_PRESETS["micro"],
                             compute_dtype="float32")
    rng = np.random.default_rng(4)
    obs = {"obs": rng.normal(size=(T, B, OBS)).astype(np.float32),
           "vision_obs": rng.normal(size=(T, B, LEVELS, 3, 2)).astype(
               np.float32)}
    dones = rng.random((T, B)) < 0.3
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    jnet = JViTActorCriticRNN(action_dim=ACT, vit=jc, continuous=False)
    params = jnet.init(jax.random.PRNGKey(4),
                       JScannedGRU.initialize_carry(B, H),
                       ({k: jnp.asarray(v) for k, v in obs.items()},
                        jnp.asarray(dones)))
    params = jax.tree.map(np.asarray, jax.device_get(params))
    net = tvit.ViTActorCriticRNN(OBS, LEVELS, ACT, tc)
    net.load_state_dict(flax_to_state_dict(params), strict=True)
    jh, jpi, jv = jnet.apply(params, jnp.asarray(h0),
                             ({k: jnp.asarray(v) for k, v in obs.items()},
                              jnp.asarray(dones)))
    acts = rng.integers(0, ACT, (T, B))
    with torch.no_grad():
        th, tpi, tv = net(torch.from_numpy(h0),
                          {k: torch.from_numpy(v) for k, v in obs.items()},
                          torch.from_numpy(dones))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(
        tpi.log_prob(torch.from_numpy(acts)).numpy(),
        np.asarray(jpi.log_prob(jnp.asarray(acts))), **tol)
    np.testing.assert_allclose(tpi.entropy().numpy(),
                               np.asarray(jpi.entropy()), **tol)


@pytest.mark.parametrize("name", CONFIGS)
def test_simplest_configs_train_on_the_cpu(name):
    raw = _raw(name)
    raw.update(NUM_ENVS=4, NUM_STEPS=4, UPDATE_EPOCHS=1, NUM_MINIBATCHES=2,
               TOTAL_TIMESTEPS=16, VIT_PRESET="micro")
    ma, tc = tcfg.make_config(raw)
    out = tppo.make_train(ma, tc, device="cpu")(seed=0)
    if name == "ippo_vision_simplest.yaml":
        assert isinstance(out["networks"][0], tvit.ViTActorCriticRNN)
        assert not out["networks"][0].continuous
    assert len(out["metrics"]) == 1
    for m in out["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert "EXE/total_loss" in m
