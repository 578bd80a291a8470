"""The port's agent spaces, ``fixed_time`` episodes, tokenizer, integer
allocation and info buffers against the JAX package.

Every market-making action, reward, inventory-penalty, portfolio-price and
observation option, and every execution action, reward and observation
space, runs in a few JAX worlds of several agent types each (so each JAX
step compiles once), stepped 3 times at E=4 from identical resets with
identical actions and the JAX package's draws, replayed from the keys its
``step_vec`` splits: window picks, task directions, action shuffles, and
the execution agents' own draws (the ``twap_v3`` split's order and the
Hamilton apportionment's tie-break uniforms, ``execution.py:230-285``).
Integer state, books and message observations must be equal; float
observations, rewards and state agree within 1e-5 (float32), as in
``tests/test_torch_env.py``.  ``fixed_time`` episodes run on a synthetic
day, and the ``fixed_time`` windows of LOBSTER CSV days (written synthetic
days and the hand-made fixture) are bit-equal to the JAX loader's.

Also: ``utils/ints.py`` against the JAX functions (Hamilton tie-breaks fed
from replayed keys), the tokenizer, the ``VIT_MARL_ABLATE`` hooks, and the
info buffers of ``env/structs.py::Info``: ``_reduce_info`` gives the same
moments as the reduction of the previous release (a stack of the fields a
element count, kept below) on the same steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_lobster_fixture import FIXTURE_ROWS, _write_fixture_day
from test_torch_env import (
    E,
    WORLD,
    _assert_close,
    _assert_state_equal,
    _reset_draws,
    _step_draws,
)
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.data import synthetic as jsyn
from vit_marl_tpu.data import tokenizer as jtok
from vit_marl_tpu.data.lobster import LobsterLoader as JLoader
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu.rl import ppo as jppo
from vit_marl_tpu.utils import ints as jints
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.data import lobster as tlob
from vit_marl_tpu_torch.data import tokenizer as ttok
from vit_marl_tpu_torch.env import base as tbase
from vit_marl_tpu_torch.env import spaces as tspaces
from vit_marl_tpu_torch.env.structs import ExecStepDraw, Info
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils import ints as tints

# ---------------------------------------------------------------------------
# worlds: (agent kind, overrides) per type, instances per type, world fields
# ---------------------------------------------------------------------------

MM, EXE = "mm", "exe"
WORLDS = {
    # market-maker actions, rewards, penalties, prices and observations
    "mm": dict(agents=[
        (MM, dict(action_space="fixed_quants", sell_buy_all_option=True,
                  reward_space="complex", inv_penalty="linear",
                  reference_price_portfolio_value="best_bid_ask",
                  observation_space="basic")),
        (MM, dict(action_space="simple", simple_nothing_action=False,
                  reward_space="spooner_damped", inv_penalty="quadratic",
                  reference_price_portfolio_value="near_touch",
                  clip_reward=True, normalize=False)),
        (MM, dict(action_space="AvSt", reward_space="delta_netWorth",
                  inv_penalty="threshold",
                  reference_price_portfolio_value="best_bid_ask",
                  exclude_extreme_spreads=True,
                  observation_space="messages")),
        (MM, dict(action_space="fixed_prices", n_actions=8,
                  reward_space="spooner_scaled",
                  observation_space="messages_tokenized")),
        (MM, dict(action_space="directional_trading",
                  reward_space="weight_pnl_inventory_pnl",
                  based_on_mid_price_of_action=False,
                  observation_space="basic", normalize=False)),
        (MM, dict(action_space="spread_skew", multiplier_type="spread",
                  reward_space="portfolio_value_scaled",
                  reference_price_portfolio_value="near_touch")),
        (EXE, dict(action_space="fixed_quants", larger_far_touch_quant=True,
                   observation_space="basic", reward_space="finish_fast")),
        (EXE, dict(action_space="fixed_quants_1msg", task="sell")),
    ], n=(1, 2, 1, 1, 1, 1, 1, 2)),
    # the remaining rewards and the execution spaces that draw
    "exe": dict(agents=[
        (MM, dict(action_space="simple", sell_buy_all_option=True,
                  fixed_action_setting=True, fixed_action=1,
                  reward_space="portfolio_value")),
        (MM, dict(reward_space="pnl", inv_penalty="linear")),
        (MM, dict(action_space="fixed_quants", reward_space="zero_inv",
                  observation_space="basic")),
        (MM, dict(action_space="AvSt", reward_space="spooner")),
        (EXE, dict(action_space="fixed_prices", n_actions=4, task_size=60,
                   observation_space="basic", normalize=False)),
        (EXE, dict(action_space="fixed_prices", n_actions=2,
                   action_type="delta", task_size=40)),
        (EXE, dict(action_space="twap", task="buy")),
        (EXE, dict(action_space="twap_v3", task_size=45,
                   reward_space="simplest_case")),
    ], n=(1, 1, 1, 1, 2, 2, 1, 2)),
    # fixed_time episodes: the 12- and 15-entry engineered observations,
    # the time-based terminals and rewards, data past the episode's end
    "fixed_time": dict(agents=[
        (MM, dict()),
        (MM, dict(action_space="AvSt", normalize=False)),
        (EXE, dict()),
        (EXE, dict(action_space="twap_v3", observation_space="basic",
                   task_size=80)),
    ], n=(1, 1, 2, 1), world=dict(ep_type="fixed_time", episode_time=120,
                                  start_resolution=120,
                                  n_data_msg_per_step=10)),
}


def _ma(c, spec):
    agents = []
    for i, (kind, kw) in enumerate(spec["agents"]):
        cls = c.MarketMakingConfig if kind == MM else c.ExecutionConfig
        agents.append(cls(short_name=f"{kind.upper()}{i}", **kw))
    return c.MultiAgentConfig(
        world=c.WorldConfig(**dict(WORLD, **spec.get("world", {}))),
        agents=tuple(agents), n_agents_per_type=spec["n"])


def _world_pair(name):
    spec = WORLDS[name]
    return (JWorldEnv(_ma(jcfg, spec)),
            WorldEnv(_ma(tcfg, spec), device="cpu"))


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world_run(request):
    return _world_run(request.param)


_RUNS = {}


def _world_run(name):
    """A world stepped 3 times on both sides, once a process: the JAX and
    port (obs, state, rewards, dones, infos) of the reset and every
    step."""
    if name not in _RUNS:
        jenv, tenv = _world_pair(name)
        _RUNS[name] = (name, jenv, tenv, _run(jenv, tenv, 3))
    return _RUNS[name]


def _uniforms(key, k):
    """The uniforms ``jax.random.choice`` turns into the Hamilton picks
    (``utils/ints.py:55-61``): a split of the key a pick."""
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(jax.random.uniform(sub, (), jnp.float32))
    return jnp.stack(out)


def _swap(key):
    """Whether ``jax.random.permutation(key, 2-vector, independent=True)``
    swaps the two levels (``execution.py:242-244``)."""
    return jax.random.permutation(key, jnp.arange(2), independent=True)[0] \
        == 1


def _agent_draws(jenv, step_keys):
    """The execution agents' draws of one ``step_vec`` from each env's step
    key (world.py:176-190, execution.py:256, :270-285, :377)."""
    n_types = len(jenv.agent_types)

    def one(k):
        build_key = jax.random.split(k)[0]
        per_type = []
        for agent, n in zip(jenv.agent_types, jenv.n_per_type):
            build_key, k_type = jax.random.split(build_key)
            space = getattr(agent.cfg, "action_space", "")
            if space not in ("twap_v3", "fixed_prices"):
                per_type.append(None)
                continue
            swaps, ties = [], []
            for inst in jax.random.split(k_type, n):
                key, k_reshape = jax.random.split(inst)
                k_twap, k_ham = jax.random.split(
                    key if space == "twap_v3" else k_reshape)
                swaps.append(_swap(k_twap))
                ties.append(_uniforms(
                    k_ham, 2 if space == "twap_v3" else agent.cfg.n_actions))
            per_type.append((jnp.stack(swaps), jnp.stack(ties)))
        return per_type

    out = jax.vmap(one)(step_keys)
    return tuple(None if d is None else ExecStepDraw(
        swap=torch.from_numpy(np.array(d[0])),
        ties=torch.from_numpy(np.array(d[1]))) for d in out[:n_types])


def _draws(jenv, key):
    d = _step_draws(jenv, key)
    _, key_step, _ = jax.random.split(key, 3)
    d.agents = _agent_draws(jenv, jax.random.split(key_step, E))
    return d


def _actions(rng, space, n):
    """Random actions: integers of a Discrete space or of an int Box, or
    floats inside a float Box; ``(E,)``/``(E, d)`` for one instance."""
    lead = (E,) if n == 1 else (E, n)
    if isinstance(space, tspaces.Discrete):
        return rng.integers(0, space.n, lead).astype(np.int32)
    if space.dtype == torch.int32:
        return rng.integers(space.low, space.high + 1,
                            lead + space.shape).astype(np.int32)
    low, high = np.asarray(space.low), np.asarray(space.high)
    return (low + (high - low) * rng.random(lead + space.shape)
            ).astype(np.float32)


def _run(jenv, tenv, n_steps):
    """Reset and step both worlds; returns a list of (JAX, port) outputs."""
    jp, tp = jenv.default_params, tenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    jobs, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jp)
    tobs, tst = tenv.reset(_reset_draws(jenv, keys), tp)
    out = [((jobs, jst, None, None, None), (tobs, tst, None, None, None))]
    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(200)
    for _ in range(n_steps):
        key, sk = jax.random.split(key)
        acts = [_actions(rng, sp, n)
                for sp, n in zip(tenv.action_spaces, tenv.n_per_type)]
        jout = jenv.step_vec(sk, jst, [jnp.asarray(a) for a in acts], jp)
        tout = tenv.step_vec(tst, [torch.from_numpy(a) for a in acts], tp,
                             draws=_draws(jenv, sk))
        jst, tst = jout[1], tout[1]
        out.append((jout, tout))
    return out


def test_world_spaces_match_jax(world_run):
    name, jenv, tenv, steps = world_run
    n_types = len(tenv.agent_types)
    for i in range(n_types):
        jsp, tsp = jenv.observation_spaces[i], tenv.observation_spaces[i]
        assert tuple(jsp.shape) == tuple(tsp.shape), (name, i)
        ja, ta = jenv.action_spaces[i], tenv.action_spaces[i]
        assert type(ja).__name__ == type(ta).__name__, (name, i)
        assert tuple(ja.shape) == tuple(ta.shape), (name, i)
    saw_reset = False
    for t, ((jobs, jst, jrew, jdone, _), (tobs, tst, trew, tdone, _)) in \
            enumerate(steps):
        _assert_state_equal(jst, tst)
        for i in range(n_types):
            _assert_close(jobs[i], tobs[i], f"{name} step {t} obs {i}")
            if jrew is None:
                continue
            _assert_close(jrew[i], trew[i], f"{name} step {t} reward {i}")
            np.testing.assert_array_equal(np.asarray(jdone["agents"][i]),
                                          tdone["agents"][i].numpy())
        if jdone is not None:
            np.testing.assert_array_equal(np.asarray(jdone["__all__"]),
                                          tdone["__all__"].numpy())
            saw_reset |= bool(tdone["__all__"].any())
    assert saw_reset, f"{name}: the episode boundary was not crossed"


def test_world_infos_match_jax(world_run):
    """The info tree of every step: the same keys, integer fields equal,
    float fields within 1e-5, and its reduced moments."""
    name, _, _, steps = world_run
    for jout, tout in steps[1:]:
        jinfo, tinfo = jout[4], tout[4]
        for j, t in [(jinfo["world"], tinfo["world"])] + list(
                zip(jinfo["agents"], tinfo["agents"])):
            assert sorted(j) == sorted(t), name
            for k in j:
                want, got = np.asarray(j[k]), t[k].numpy()
                if np.issubdtype(want.dtype, np.integer) or \
                        want.dtype == bool:
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5, err_msg=k)
        want = jppo._reduce_info(jinfo)
        got = tppo._reduce_info(tinfo)
        for w, g in [(want["world"], got["world"])] + list(
                zip(want["agents"], got["agents"])):
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


def test_message_observations_carry_the_stream():
    """``messages`` is the world's combined stream of the step, blank at
    reset; ``messages_tokenized`` is 84 book tokens + 13 a message."""
    _, _, tenv, steps = _world_run("mm")
    M = tenv.num_msgs_per_step
    reset_obs = steps[0][1][0]
    assert reset_obs[2].shape == (E, 1, M, 8) and not reset_obs[2].any()
    assert reset_obs[3].shape == (E, 1, 13 * M + 84)
    assert tenv.observation_spaces[3].shape == (13 * M + 84,)
    obs = steps[1][1][0][2]
    assert obs.dtype == torch.int32 and obs.abs().sum() > 0


def test_fixed_time_lobster_windows_bit_equal(tmp_path):
    """``fixed_time`` windows of LOBSTER CSV days (two written synthetic
    days and the hand-made fixture) through both loaders."""
    base = os.path.join(tmp_path, "SYNTH", "2024-01")
    for d in range(2):
        day = jsyn.generate_day(seed=d, n_messages=2000, levels=10)
        jsyn.write_day_csvs(day, base, stock="SYNTH",
                            date=f"2024-01-0{d + 2}")
    _write_fixture_day(base, FIXTURE_ROWS, name="SYNTH_fix_message_10.csv")
    fields = dict(data_path=str(tmp_path), stock="SYNTH",
                  time_period="2024-01", cache_dir="", ep_type="fixed_time",
                  episode_time=600, start_resolution=300,
                  n_data_msg_per_step=10)
    want = JLoader(jcfg.WorldConfig(**fields)).run_loading()
    got = tlob.load_data(tcfg.WorldConfig(**fields))
    assert got.n_windows == want.n_windows > 20
    for f in ("messages", "starts", "ends", "init_books",
              "max_msgs_per_window"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)


def test_fixed_time_zeroes_data_past_the_end():
    """Past the episode's end the data messages keep only their times."""
    _, _, tenv, steps = _world_run("fixed_time")
    state = steps[0][1][1]
    params = tenv.default_params
    end = state.world.init_time[:, 0] + tenv.wcfg.episode_time
    later = state.world.step_counter + 40
    msgs = tbase.get_data_messages(tenv.wcfg, params.world.message_data,
                                  state.world.start_index, later, end)
    past = msgs[:, :, 6] >= end[:, None]
    assert past.any()
    assert not msgs[:, :, :6][past].any()
    assert (msgs[:, :, 6:][past] != 0).any()


# ---------------------------------------------------------------------------
# utils/ints.py
# ---------------------------------------------------------------------------

def _int_vectors(rng, n, k):
    """Vectors with ties among their largest entries."""
    v = rng.integers(0, 6, (n, k)).astype(np.int32)
    v[::3, :2] = 4
    return v


@pytest.mark.parametrize("k", [2, 4, 5])
def test_ints_sorts_and_clip_match_jax(k):
    rng = np.random.default_rng(k)
    v = _int_vectors(rng, 64, k)
    cap = rng.integers(0, 12, 64).astype(np.int32)
    want = jax.vmap(jints.argsort_rev)(jnp.asarray(v))
    np.testing.assert_array_equal(
        tints.argsort_rev(torch.from_numpy(v)).numpy(), np.asarray(want))
    want = jax.vmap(jints.rank_rev)(jnp.asarray(v))
    np.testing.assert_array_equal(
        tints.rank_rev(torch.from_numpy(v)).numpy(), np.asarray(want))
    want = jax.vmap(jints.clip_by_sum_int)(jnp.asarray(v), jnp.asarray(cap))
    got = tints.clip_by_sum_int(torch.from_numpy(v), torch.from_numpy(cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    over = v.sum(-1) > cap
    assert over.any() and (~over).any()
    np.testing.assert_array_equal(got.sum(-1).numpy()[over], cap[over])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_hamilton_matches_jax_on_replayed_keys(k):
    """Ties among the largest remainders are broken by the uniforms the
    JAX package draws from the same keys."""
    rng = np.random.default_rng(10 + k)
    votes = _int_vectors(rng, 200, k) * 7 + 1
    seats = (votes.sum(-1) // 2).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(k), 200)
    want = jax.vmap(jints.hamilton_apportionment_permuted)(
        jnp.asarray(votes), jnp.asarray(seats), keys)
    u = jax.vmap(lambda key: _uniforms(key, k))(keys)
    got = tints.hamilton_apportionment_permuted(
        torch.from_numpy(votes), torch.from_numpy(seats),
        torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(-1).numpy(), seats)


def test_hamilton_tie_breaks_are_uniform():
    """Equal votes: each maximum gets the unit left over equally often."""
    votes = torch.full((6000, 3), 5, dtype=torch.int32)
    seats = torch.full((6000,), 13)
    gen = torch.Generator().manual_seed(0)
    got = tints.hamilton_apportionment_permuted(
        votes, seats, torch.rand((6000, 3), generator=gen))
    assert (got.sum(-1) == 13).all()
    share = (got == 5).float().mean(0)         # who got one unit less
    np.testing.assert_allclose(share.numpy(), 1 / 3, atol=0.03)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def test_tokenizer_matches_jax():
    rng = np.random.default_rng(4)
    n, M = 5, 13
    msgs = np.stack([
        rng.integers(1, 5, (n, M)), rng.choice([-1, 1], (n, M)),
        rng.integers(0, 300, (n, M)), rng.integers(2_190_000, 2_210_000,
                                                   (n, M)),
        rng.integers(-10**6, 10**6, (n, M)), rng.integers(-200, 10, (n, M)),
        np.sort(rng.integers(34_200, 34_260, (n, M)), 1),
        rng.integers(0, 10**9, (n, M))], -1).astype(np.int32)
    bids = np.stack([rng.integers(2_190_000, 2_200_000, (n, M)),
                     rng.integers(0, 50, (n, M))], -1).astype(np.int32)
    asks = bids + np.array([20_000, 3], np.int32)
    mid = rng.normal(2_200_000, 3000, n).astype(np.float32)
    l2 = rng.integers(-1, 2_300_000, (n, 40)).astype(np.int32)
    time = msgs[:, -1, 6:]
    want = jax.vmap(lambda *a: jtok.tokenize_observation(
        jtok.DEFAULT_TOKENIZER, *a))(*map(jnp.asarray, (msgs, bids, asks,
                                                        mid, l2, time)))
    got = ttok.tokenize_observation(ttok.DEFAULT_TOKENIZER,
                                    *map(torch.from_numpy,
                                         (msgs, bids, asks, mid, l2, time)))
    assert got.shape == (n, 84 + 13 * M) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    assert ttok.DEFAULT_TOKENIZER.TOTAL_NUM_TOKENS == \
        jtok.DEFAULT_TOKENIZER.TOTAL_NUM_TOKENS


# ---------------------------------------------------------------------------
# ablation hooks and the info buffers
# ---------------------------------------------------------------------------

def test_ablate_hooks_warn_and_skip(monkeypatch, capsys):
    monkeypatch.setenv("VIT_MARL_ABLATE", "obs,reset,data")
    env = WorldEnv(tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD)),
                   device="cpu")
    assert "VIT_MARL_ABLATE=['data', 'obs', 'reset']" in \
        capsys.readouterr().err
    gen = torch.Generator().manual_seed(0)
    params = env.default_params
    _, state = env.reset(env.draw_reset(E, gen), params)
    acts = [torch.zeros(E, dtype=torch.int64)] * 2
    obs, state, _, _, _ = env.step_vec(state, acts, params, generator=gen)
    assert all(not o.any() for o in obs)
    combined, _ = env._build_messages(state, env._actions(acts), params,
                                      None)
    assert not combined[:, -env.wcfg.n_data_msg_per_step:].any()


def _stacked_reduce_info(info):
    """The previous release's reduction: per element count, one stack of
    the fields cast to float32, a mean and a mean of squares."""
    def moments(fields, squares):
        out, groups = {}, {}
        for k, v in fields.items():
            groups.setdefault(v.numel(), []).append(k)
        for keys in groups.values():
            x = torch.stack([fields[k].reshape(-1) for k in keys]).to(
                torch.float32)
            m = torch.stack([x.mean(1), x.square().mean(1)], 1) \
                if squares else x.mean(1)
            out.update(zip(keys, m))
        return {k: out[k] for k in fields}
    return {"agents": [moments(dict(inf), True) for inf in info["agents"]],
            "world": moments(dict(info["world"]), False)}


def test_info_buffers_reduce_as_before(world_run):
    """The buffers' moments equal the previous release's on the same
    steps, and each buffer holds one (dtype, shape) of fields."""
    _, _, _, steps = world_run
    for _, tout in steps[1:]:
        info = tout[4]
        for inf in [info["world"]] + list(info["agents"]):
            assert isinstance(inf, Info)
            kinds = [(b.dtype, tuple(b.shape[1:])) for _, b in inf.buffers]
            assert len(set(kinds)) == len(kinds)
        want, got = _stacked_reduce_info(info), tppo._reduce_info(info)
        for w, g in [(want["world"], got["world"])] + list(
                zip(want["agents"], got["agents"])):
            assert list(w) == list(g)
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), w[k].numpy(),
                                           rtol=2e-7, atol=0, err_msg=k)
