"""The port's config, data, book queries and world step against the JAX
package.

``step_vec`` is compared from identical reset states with identical
actions and identical draws: the JAX package's threefry draws (window
picks, task directions, action shuffles) are recomputed here from the keys
its ``step_vec`` splits and handed to the port.  The JAX side runs its XLA
engine (the CPU path) and derives rewards from its trade log; the port runs
its plain book scan and derives them from the scan's per-trader sums.
Integer state, messages, dones and book must be equal; float observations,
rewards and state agree within atol/rtol 1e-5 (float32).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit_marl_tpu import config as jcfg
from vit_marl_tpu.data.lobster import load_data as j_load_data
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu.lob import book as jbk
from vit_marl_tpu.ops.book_kernel import _per_message_uniforms
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.data.lobster import load_data as t_load_data
from vit_marl_tpu_torch.env import spaces as tspaces
from vit_marl_tpu_torch.env.structs import ResetDraws, StepDraws
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.lob import book as tbk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("price", "quant", "oid", "tid", "time_s", "time_ns")
E = 4
WORLD = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)


def _config_files():
    return sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", _config_files(),
                         ids=lambda p: os.path.basename(p))
def test_configs_load_to_equal_values(path):
    """Every committed config; of a sweep config its base run, the file
    without its ``SWEEP:`` grid (as ``vit_marl_tpu/rl/sweep.py:168``
    drops it)."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if "SWEEP" in raw:
        raw.pop("SWEEP")
        (jm, jt), (tm, tt) = jcfg.make_config(raw), tcfg.make_config(raw)
    else:
        jm, jt = jcfg.load_yaml_config(path)
        tm, tt = tcfg.load_yaml_config(path)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert jt.num_updates == tt.num_updates
    assert jm.num_msgs_per_step == tm.num_msgs_per_step


def test_config_string_coercion_and_defaults():
    raw = {"TOTAL_TIMESTEPS": "3.0e6", "ANNEAL_LR": "false",
           "WORLD": {"N_ORDERS": "64"}}
    jm, jt = jcfg.make_config(raw)
    tm, tt = tcfg.make_config(raw)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert tt.total_timesteps == 3e6 and tt.anneal_lr is False
    with pytest.raises(ValueError, match="unknown config key"):
        tcfg.make_config({"NOT_A_KEY": 1})


def test_synthetic_data_equal():
    jd = j_load_data(jcfg.WorldConfig(**WORLD))
    td = t_load_data(tcfg.WorldConfig(**WORLD))
    for f in ("messages", "starts", "ends", "init_books",
              "max_msgs_per_window"):
        np.testing.assert_array_equal(getattr(jd, f), getattr(td, f),
                                      err_msg=f)
    assert td.n_windows > 1


def _random_books(rng, n, S):
    occ = rng.random((n, 2, S)) < 0.6
    lvl = np.cumsum(rng.integers(0, 2, (n, 2, S)) * 100 * occ, axis=2)
    price = np.stack([2_200_100 + lvl[:, 0], 2_199_900 - lvl[:, 1]], 1)
    tid = rng.choice([-100, -101, 5, 6], (n, 2, S))
    q = rng.integers(1, 50, (n, 2, S))
    oid = rng.integers(1, 10**6, (n, 2, S))
    ts = np.broadcast_to(34_200 + np.arange(S), (n, 2, S))
    book = np.stack([price, q, oid, tid, ts, ts * 0], 2)
    return np.where(occ[:, :, None], book, -1).astype(np.int32)


def test_book_queries_match():
    rng = np.random.default_rng(1)
    book = _random_books(rng, 5, 32)
    cfg = tcfg.EngineConfig(n_orders=32)
    jcf = jcfg.EngineConfig(n_orders=32)
    tb = tbk.BookState(torch.from_numpy(book))
    sides = [jbk.SideState(*[jnp.asarray(book[:, s, f]) for f in range(6)])
             for s in (0, 1)]
    a, b = tbk.best_bid_and_ask_incl_quants(cfg, tb)
    ja, jb = jax.vmap(lambda x, y: jbk.best_bid_and_ask_incl_quants(
        jcf, x, y))(*sides)
    np.testing.assert_array_equal(np.asarray(ja), a.numpy())
    np.testing.assert_array_equal(np.asarray(jb), b.numpy())
    l2 = tbk.get_l2_state(cfg, 10, tb)
    jl2 = jax.vmap(lambda x, y: jbk.get_l2_state(jcf, 10, x, y))(*sides)
    np.testing.assert_array_equal(np.asarray(jl2), l2.numpy())
    tid = torch.tensor([[-100], [-101], [-100], [7], [-101]],
                       dtype=torch.int32)
    t_s = torch.full((5,), 34_300, dtype=torch.int32)
    got = tbk.make_cancel_msgs(tb.bids, tid, 4, 1, t_s, t_s * 0)
    want = jax.vmap(lambda sd, i: jbk.make_cancel_msgs(
        sd, i, 4, 1, 34_300, 0))(sides[1], jnp.asarray(tid[:, 0].numpy()))
    np.testing.assert_array_equal(np.asarray(want), got[:, 0].numpy())
    l2row = np.array(jl2[0])
    jm = jbk.init_msgs_from_l2(jcf, jnp.asarray(l2row),
                               jnp.asarray([34_200, 5]))
    tm = tbk.init_msgs_from_l2(cfg, torch.from_numpy(l2row.copy())[None],
                               torch.tensor([[34_200, 5]]))
    np.testing.assert_array_equal(np.asarray(jm), tm[0].numpy())


# --------------------------------------------------------------------------
# world step
# --------------------------------------------------------------------------


def _env_pair(n_per_type=(1, 1), exe=None):
    """JAX and port worlds of the same config; ``exe`` overrides the
    execution agent's fields."""
    exe = exe or {}
    jenv = JWorldEnv(jcfg.MultiAgentConfig(
        world=jcfg.WorldConfig(**WORLD), n_agents_per_type=n_per_type,
        agents=(jcfg.MarketMakingConfig(), jcfg.ExecutionConfig(**exe))))
    tenv = WorldEnv(tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**WORLD), n_agents_per_type=n_per_type,
        agents=(tcfg.MarketMakingConfig(), tcfg.ExecutionConfig(**exe))),
        device="cpu")
    return jenv, tenv


VISION = dict(action_space="policy_blending",
              observation_space="execution_policy", reward_space="dual_ppo",
              use_vision_obs=True, task_size=500)


@pytest.fixture(scope="module")
def envs():
    return _env_pair()


def _reset_draws(jenv, keys):
    """The draws ``reset_env`` makes from each env's key."""
    n_types = len(jenv.agent_types)

    # the execution agents' task directions; the market maker draws none
    random_task = [getattr(a.cfg, "task", None) == "random"
                   for a in jenv.agent_types]

    def one(k):
        ks = jax.random.split(k, n_types + 1)
        window = jax.random.randint(ks[-1], (), 0, jenv.n_windows)
        tasks = [jax.random.randint(ks[i], (), 0, 2) if r else None
                 for i, r in enumerate(random_task)]
        return window, tasks

    window, tasks = jax.vmap(one)(keys)
    return ResetDraws(window=torch.from_numpy(np.array(window)),
                      agents=tuple(None if t is None
                                   else torch.from_numpy(np.array(t))
                                   for t in tasks))


def _step_draws(jenv, key):
    """The draws ``step_vec`` makes from ``key`` (world.py:157-207,
    366-371, 399-400)."""
    n_types = len(jenv.agent_types)
    key, key_step, key_reset = jax.random.split(key, 3)
    step_keys = jax.random.split(key_step, E)
    reset_keys = jax.random.split(key_reset, E)

    def perm(k):
        build_key = jax.random.split(k)[0]
        for _ in range(n_types):
            build_key, _ = jax.random.split(build_key)
        _, sk = jax.random.split(build_key)
        return jax.random.permutation(sk, jenv.num_action_msgs_per_step)

    shuffle = jax.vmap(perm)(step_keys)
    uniforms = None
    if jenv.wcfg.cancel_mode >= jcfg.CancelMode.CANCEL_UNIFORM:
        # the engine's per-message draws from each env's engine key
        # (world.py:399-400, book_kernel.py:448-461)
        engine_keys = jax.vmap(jax.random.split)(step_keys)[:, 1]
        uniforms = torch.from_numpy(np.array(_per_message_uniforms(
            engine_keys, jenv.num_msgs_per_step)))
    return StepDraws(shuffle=torch.from_numpy(np.array(shuffle)),
                     uniforms=uniforms, reset=_reset_draws(jenv, reset_keys))


def _book(world):
    side = lambda s: np.stack(  # noqa: E731
        [np.asarray(getattr(s, f)) for f in FIELDS], 1)
    return np.stack([side(world.asks), side(world.bids)], 1)


def _assert_state_equal(jst, tst):
    jw, tw = jst.world, tst.world
    np.testing.assert_array_equal(_book(jw), tw.book.numpy())
    for f in ("init_time", "window_index", "max_steps_in_episode",
              "start_index", "step_counter", "best_bids", "best_asks",
              "time", "order_id_counter"):
        np.testing.assert_array_equal(np.asarray(getattr(jw, f)),
                                      getattr(tw, f).numpy(), err_msg=f)
    if tw.trades is not None:
        np.testing.assert_array_equal(np.asarray(jw.trades),
                                      tw.trades.numpy(), err_msg="trades")
    for f in ("mid_price", "delta_time"):
        np.testing.assert_allclose(np.asarray(getattr(jw, f)),
                                   getattr(tw, f).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for ja, ta in zip(jst.agents, tst.agents):
        for f in dataclasses.fields(ta):
            want = np.asarray(getattr(ja, f.name))
            got = getattr(ta, f.name).numpy()
            if np.issubdtype(want.dtype, np.integer):
                np.testing.assert_array_equal(want, got, err_msg=f.name)
            else:
                np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-5,
                                           err_msg=f.name)


def _assert_close(want, got, name):
    """Leaf by leaf: a dict observation compares each entry."""
    if isinstance(got, dict):
        assert set(want) == set(got), name
        for k in got:
            _assert_close(want[k], got[k], f"{name}[{k}]")
        return
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_step_vec_matches_jax(envs, n_steps):
    _run_steps(*envs, n_steps)


def test_step_vec_matches_jax_with_several_agents_per_type():
    """Two market makers and three execution agents per env: per-instance
    trader ids, cancels, sums and actions of shape (E, n)."""
    _run_steps(*_env_pair((2, 3)), 3)


@pytest.mark.parametrize("aggressive", [False, True],
                         ids=["passive", "blend_aggressive"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_vision_step_vec_matches_jax(n_steps, aggressive):
    """The ``ippo_vision_dual_ppo`` world: ``policy_blending`` continuous
    actions, ``dual_ppo`` rewards, ``execution_policy`` + book-image dict
    observations."""
    jenv, tenv = _env_pair(exe=dict(VISION, blend_aggressive=aggressive))
    assert isinstance(tenv.observation_spaces[1], tspaces.Dict)
    _run_steps(jenv, tenv, n_steps)


def test_vision_l2_state_matches_jax():
    rng = np.random.default_rng(3)
    book = _random_books(rng, 6, 32)
    sides = [jbk.SideState(*[jnp.asarray(book[:, s, f]) for f in range(6)])
             for s in (0, 1)]
    for levels in (3, 10, 40):
        want = jax.vmap(lambda x, y: jbk.get_vision_l2_state(
            jcfg.EngineConfig(n_orders=32), levels, x, y))(*sides)
        got = tbk.get_vision_l2_state(tcfg.EngineConfig(n_orders=32), levels,
                                      tbk.BookState(torch.from_numpy(book)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _actions(rng, space, n):
    """Random actions: integers of a Discrete space, or floats inside a
    Box's bounds; ``(E,)``/``(E, d)`` for one instance, else with ``n``."""
    lead = (E,) if n == 1 else (E, n)
    if isinstance(space, tspaces.Discrete):
        return rng.integers(0, space.n, lead).astype(np.int32)
    low, high = space.low.numpy(), space.high.numpy()
    return (low + (high - low) * rng.random(lead + space.shape)
            ).astype(np.float32)


def _run_steps(jenv, tenv, n_steps):
    jp, tp = jenv.default_params, tenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    jobs, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jp)
    tobs, tst = tenv.reset(_reset_draws(jenv, keys), tp)
    _assert_state_equal(jst, tst)
    n_types = len(tenv.agent_types)
    for i in range(n_types):
        _assert_close(jobs[i], tobs[i], f"reset obs {i}")

    rng = np.random.default_rng(n_steps)
    key = jax.random.PRNGKey(100 + n_steps)
    saw_reset = False
    for t in range(n_steps):
        key, sk = jax.random.split(key)
        acts = [_actions(rng, sp, n)
                for sp, n in zip(tenv.action_spaces, tenv.n_per_type)]
        jobs, jst, jrew, jdone, _ = jenv.step_vec(
            sk, jst, [jnp.asarray(a) for a in acts], jp)
        tobs, tst, trew, tdone, _ = tenv.step_vec(
            tst, [torch.from_numpy(a) for a in acts], tp,
            draws=_step_draws(jenv, sk))
        _assert_state_equal(jst, tst)
        for i in range(n_types):
            _assert_close(jobs[i], tobs[i], f"step {t} obs {i}")
            _assert_close(jrew[i], trew[i], f"step {t} reward {i}")
            np.testing.assert_array_equal(np.asarray(jdone["agents"][i]),
                                          tdone["agents"][i].numpy())
        np.testing.assert_array_equal(np.asarray(jdone["__all__"]),
                                      tdone["__all__"].numpy())
        saw_reset |= bool(tdone["__all__"].any())
    if n_steps == 3:
        assert saw_reset, "the episode boundary was not crossed"


def test_single_agent_actions_get_the_agent_axis_whatever_their_rank(envs):
    """A single-instance type's (E, 3) continuous action is one agent's
    action, not three agents' scalars: the agent axis is always added, as
    the JAX package does (world.py:179-180)."""
    _, tenv = envs
    got = tenv._actions([torch.zeros(E, dtype=torch.int32),
                         torch.zeros(E, 3)])
    assert [tuple(a.shape) for a in got] == [(E, 1), (E, 1, 3)]


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorldEnv(tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD)))
