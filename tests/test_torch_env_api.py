"""The port's per-env gymnax API against the JAX package's.

``WorldEnv.reset_env``, ``step_env`` and ``step`` (across an auto-reset)
run one env from identical states with identical actions and the JAX
package's draws, replayed from the keys its functions split: the window
pick and task direction of a reset, the action shuffle, the engine's
random-cancel uniforms and the reset keys of ``step``.  Both run the XLA
scan (``lob/engine.py`` in the port) with the uncapped trade log, so the
logs are bit-equal, also on an order-id corner that the batched step's
book scan resolves otherwise.  Also: ``get_action_msgs`` of every
market-making and execution action space, the spaces' ``sample`` and
``contains``, the trade-log helpers of ``env/common.py`` (cases as in
``tests/test_trade_summary.py``) and ``env/base.py::state_from_data``.

Tolerances: integer state, books, trade logs, messages and dones equal;
float observations, rewards and state within atol/rtol 1e-5 (float32), as
in ``tests/test_torch_env.py``; ``rolling_mean`` bit-equal to the jitted
JAX function (the port rounds the product and sum once, as XLA's fused
multiply-add does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import (
    WORLD,
    _assert_close,
    _assert_state_equal,
    _env_pair,
    _reset_draws,
)
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.data.lobster import load_data as j_load_data
from vit_marl_tpu.env import base as jbase
from vit_marl_tpu.env import common as jcommon
from vit_marl_tpu.env import spaces as jspaces
from vit_marl_tpu.env.execution import ExecutionAgent as JExec
from vit_marl_tpu.env.mm import MarketMakingAgent as JMM
from vit_marl_tpu.env.structs import ExecState as JExecState
from vit_marl_tpu.env.structs import MMState as JMMState
from vit_marl_tpu.lob import book as jbk
from vit_marl_tpu.ops.book_kernel import _per_message_uniforms
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.data.lobster import load_data as t_load_data
from vit_marl_tpu_torch.env import base as tbase
from vit_marl_tpu_torch.env import common as tcommon
from vit_marl_tpu_torch.env import spaces as tspaces
from vit_marl_tpu_torch.env.execution import ExecutionAgent as TExec
from vit_marl_tpu_torch.env.mm import MarketMakingAgent as TMM
from vit_marl_tpu_torch.env.structs import ExecState as TExecState
from vit_marl_tpu_torch.env.structs import (
    ExecStepDraw,
    ResetDraws,
    StepDraws,
)
from vit_marl_tpu_torch.env.structs import MMState as TMMState
from vit_marl_tpu_torch.utils.tree import tree_map

from test_torch_spaces import _swap, _uniforms

CORNER_OID = 777_777


@pytest.fixture(scope="module")
def envs():
    return _env_pair()


def _env_reset_draws(jenv, key):
    """The draws of ``reset_env(key)``, one env's."""
    d = _reset_draws(jenv, key[None])
    return ResetDraws(window=d.window[0], agents=tuple(
        None if a is None else a[0] for a in d.agents))


def _env_step_draws(jenv, key):
    """The draws of ``step_env(key)`` (world.py:157-207, :325-331): the
    action shuffle from the build key, the engine's uniforms from the
    engine key; and the reset draws ``step(key)`` makes from the key it
    splits off first (world.py:492-495), with the step's own key."""
    key_step, key_reset = jax.random.split(key)
    build_key, engine_key = jax.random.split(key_step)
    for _ in jenv.agent_types:
        build_key, _ = jax.random.split(build_key)
    _, sk = jax.random.split(build_key)
    shuffle = jax.random.permutation(sk, jenv.num_action_msgs_per_step)
    uniforms = None
    if jenv.wcfg.cancel_mode >= jcfg.CancelMode.CANCEL_UNIFORM:
        uniforms = torch.from_numpy(np.array(_per_message_uniforms(
            engine_key[None], jenv.num_msgs_per_step)))[:, 0]
    return key_step, StepDraws(
        shuffle=torch.from_numpy(np.array(shuffle)), uniforms=uniforms,
        reset=_env_reset_draws(jenv, key_reset))


def _batched(jtree, ttree):
    """Both states with an env axis of one, for ``_assert_state_equal``."""
    return (jax.tree.map(lambda x: x[None], jtree),
            tree_map(lambda v: v[None], ttree))


def _actions(rng, tenv):
    """One env's actions: unbatched for a single instance."""
    acts = []
    for sp, n in zip(tenv.action_space(), tenv.n_per_type):
        a = rng.integers(0, sp.n, () if n == 1 else (n,)).astype(np.int32)
        acts.append(a)
    return acts


def _check_step(jout, tout, label):
    jobs, jst, jrew, jdone, jinfo = jout
    tobs, tst, trew, tdone, tinfo = tout
    _assert_state_equal(*_batched(jst, tst))
    assert tst.world.trades.shape == (WORLD_TRADES, 8)
    for i in range(len(tobs)):
        _assert_close(jobs[i], tobs[i], f"{label} obs {i}")
        _assert_close(jrew[i], trew[i], f"{label} reward {i}")
        np.testing.assert_array_equal(np.asarray(jdone["agents"][i]),
                                      tdone["agents"][i].numpy())
        for k in jinfo["agents"][i]:
            _assert_close(jinfo["agents"][i][k], tinfo["agents"][i][k],
                          f"{label} info {i} {k}")
    assert bool(jdone["__all__"]) == bool(tdone["__all__"])
    for k in jinfo["world"]:
        _assert_close(jinfo["world"][k], tinfo["world"][k],
                      f"{label} world info {k}")


WORLD_TRADES = jcfg.WorldConfig(**WORLD).n_trades


def test_reset_env_and_steps_match_jax(envs):
    """``reset_env``, then ``step_env`` and ``step`` in turns for 6 steps,
    through an episode's end (the auto-reset of ``step``); every step's
    trade log bit-equal, and fills in it."""
    jenv, tenv = envs
    jp, tp = jenv.default_params, tenv.default_params
    key = jax.random.PRNGKey(5)
    jobs, jst = jenv.reset_env(key, jp)
    tobs, tst = tenv.reset_env(_env_reset_draws(jenv, key), tp)
    _assert_state_equal(*_batched(jst, tst))
    for i in range(len(tobs)):
        _assert_close(jobs[i], tobs[i], f"reset obs {i}")
    rng = np.random.default_rng(2)
    fills = resets = 0
    for t in range(6):
        key, sk = jax.random.split(key)
        acts = _actions(rng, tenv)
        key_step, draws = _env_step_draws(jenv, sk)
        jargs = [jnp.asarray(a) for a in acts]
        if t % 2:
            jout = jenv.step(sk, jst, jargs, jp)
            tout = tenv.step(tst, [torch.from_numpy(a) for a in acts], tp,
                             draws=draws)
        else:
            jout = jenv.step_env(key_step, jst, jargs, jp)
            tout = tenv.step_env(tst, [torch.from_numpy(a) for a in acts],
                                 tp, draws=draws)
        _check_step(jout, tout, f"step {t}")
        jst, tst = jout[1], tout[1]
        fills += int((np.asarray(jst.world.trades)[:, 0] != -1).sum())
        resets += bool(tout[3]["__all__"]) and t % 2
    assert fills > 0 and resets > 0


def _plant_id_corner(jst, tst, mm_tid):
    """Both states' bid sides: behind the last live bid a hole whose stale
    order id is ``CORNER_OID``, then a live order of the market maker with
    that id, 50 ticks below every bid.  The market maker cancels its
    order: the XLA scan's cancel takes the hole (the first slot whose id
    plane holds the id), the book scan's the live order."""
    bids = tst.world.book[1].numpy().copy()                 # (6, S)
    last = int(np.flatnonzero(bids[0] != -1)[-1])
    bids[:, last + 1] = [-1, 4, CORNER_OID, 31, 1, 2]
    bids[:, last + 2] = [bids[0, last] - 50 * 100, 3, CORNER_OID, mm_tid,
                         int(tst.world.time[0]), 0]
    book = tst.world.book.clone()
    book[1] = torch.from_numpy(bids)
    tst = tst.replace(world=tst.world.replace(book=book))
    side = jbk.SideState(*[jnp.asarray(bids[f]) for f in range(6)])
    jst = jst.replace(world=jst.world.replace(bids=side))
    return jst, tst, last + 2


def test_step_env_matches_jax_on_an_order_id_corner(envs):
    """On the corner, ``step_env`` equals the JAX ``step_env`` (the order
    stays, the hole is wiped), while the port's batched ``step_vec`` (the
    book scan, the Pallas kernel's semantics) cancels the order."""
    jenv, tenv = envs
    jp, tp = jenv.default_params, tenv.default_params
    key = jax.random.PRNGKey(8)
    _, jst = jenv.reset_env(key, jp)
    _, tst = tenv.reset_env(_env_reset_draws(jenv, key), tp)
    mm_tid = int(tp.agents[0].trader_id[0])
    jst, tst, slot = _plant_id_corner(jst, tst, mm_tid)
    _assert_state_equal(*_batched(jst, tst))
    acts = _actions(np.random.default_rng(0), tenv)
    key_step, draws = _env_step_draws(jenv, jax.random.PRNGKey(9))
    jout = jenv.step_env(key_step, jst, [jnp.asarray(a) for a in acts], jp)
    tout = tenv.step_env(tst, [torch.from_numpy(a) for a in acts], tp,
                         draws=draws)
    _check_step(jout, tout, "corner")
    kept = tout[1].world.book[1]
    assert ((kept[2] == CORNER_OID) & (kept[0] != -1)).any()
    batch = tree_map(lambda v: v[None], tst)
    vec = tenv.step_vec(batch, [torch.from_numpy(a)[None] for a in acts],
                        tp, draws=StepDraws(
                            shuffle=draws.shuffle[None], uniforms=None,
                            reset=tree_map(lambda v: v[None], draws.reset)))
    gone = vec[1].world.book[0, 1]
    assert not ((gone[2] == CORNER_OID) & (gone[0] != -1)).any()


def test_step_draws_from_a_generator(envs):
    """Without draws, the per-env API draws from the generator: the same
    seed gives the same episode; the state keeps the env's shapes."""
    _, tenv = envs
    tp = tenv.default_params
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        obs, st = tenv.reset_env(None, tp, generator=g)
        for _ in range(3):
            acts = [sp.sample(g) for sp in tenv.action_space()]
            obs, st, rew, done, _ = tenv.step(st, acts, tp, generator=g)
        runs.append((st.world.book, st.world.trades, rew[1]))
    assert runs[0][0].shape == (2, 6, WORLD["n_orders"])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert tenv.observation_space() is tenv.observation_spaces


# --------------------------------------------------------------------------
# get_action_msgs
# --------------------------------------------------------------------------

E_MSGS = 3
MM_SPACES = [dict(action_space="fixed_quants", sell_buy_all_option=True),
             dict(action_space="simple", simple_nothing_action=False),
             dict(action_space="AvSt"),
             dict(action_space="spread_skew", multiplier_type="spread"),
             dict(action_space="directional_trading"),
             dict(action_space="fixed_prices", n_actions=8)]
EXEC_SPACES = [dict(action_space="fixed_quants", larger_far_touch_quant=True),
               dict(action_space="fixed_quants_complex"),
               dict(action_space="fixed_quants_1msg"),
               dict(action_space="simplest_case"),
               dict(action_space="fixed_prices", n_actions=4),
               dict(action_space="fixed_prices", n_actions=2),
               dict(action_space="twap"),
               dict(action_space="policy_blending"),
               dict(action_space="twap_v3")]


@pytest.fixture(scope="module")
def worlds(envs):
    """Reset world states of E_MSGS envs, JAX and port, from one set of
    keys."""
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(21), E_MSGS)
    _, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys,
                                                     jenv.default_params)
    _, tst = tenv.reset(_reset_draws(jenv, keys), tenv.default_params)
    return jst.world, tst.world


def _agent_state(kind, rng, n):
    """Random agent states of ``n`` instances a env, as numpy fields."""
    shape = (E_MSGS, n)
    if kind == "mm":
        return dict(inventory=rng.integers(-30, 30, shape).astype(np.int32),
                    total_PnL=rng.normal(0, 50, shape).astype(np.float32),
                    cash_balance=rng.normal(0, 50, shape).astype(np.float32))
    task = rng.integers(50, 400, shape).astype(np.int32)
    z = np.zeros(shape, np.float32)
    return dict(init_price=np.full(shape, 2_200_000, np.int32),
                task_to_execute=task,
                quant_executed=(task * rng.random(shape)).astype(np.int32),
                total_revenue=z, drift_return=z, advantage_return=z,
                slippage_rm=z, price_adv_rm=z, price_drift_rm=z, vwap_rm=z,
                is_sell_task=rng.integers(0, 2, shape).astype(np.int32),
                trade_duration=z)


def _random_actions(rng, space, n):
    lead = (E_MSGS, n)
    if isinstance(space, tspaces.Discrete):
        return rng.integers(0, space.n, lead).astype(np.int32)
    if space.dtype == torch.int32:
        return rng.integers(0, 40, lead + space.shape).astype(np.int32)
    low = np.broadcast_to(np.asarray(space.low), space.shape)
    high = np.broadcast_to(np.asarray(space.high), space.shape)
    return (low + (high - low) * rng.random(lead + space.shape)).astype(
        np.float32)


@pytest.mark.parametrize("kind,kw", [("mm", kw) for kw in MM_SPACES]
                         + [("exe", kw) for kw in EXEC_SPACES],
                         ids=lambda v: v if isinstance(v, str)
                         else "-".join(str(x) for x in v.values()))
def test_get_action_msgs_matches_jax(worlds, kind, kw):
    """One agent type of each action space, two instances a env, random
    states and actions (a ``fixed_prices`` action as its reshape gives
    it), on three envs' reset worlds; ``twap_v3`` takes the draws of the
    JAX key of each instance."""
    jworld, tworld = worlds
    n = 2
    wj, wt = jcfg.WorldConfig(**WORLD), tcfg.WorldConfig(**WORLD)
    if kind == "mm":
        ja, ta = JMM(jcfg.MarketMakingConfig(**kw), wj), TMM(
            tcfg.MarketMakingConfig(**kw), wt)
    else:
        ja, ta = JExec(jcfg.ExecutionConfig(**kw), wj), TExec(
            tcfg.ExecutionConfig(**kw), wt)
    jp, _ = ja.default_params(-100, n)
    tp, _ = ta.default_params(-100, n, torch.device("cpu"))
    rng = np.random.default_rng(len(kw) * 7 + len(kind))
    fields = _agent_state(kind, rng, n)
    jcls, tcls = ((JMMState, TMMState) if kind == "mm"
                  else (JExecState, TExecState))
    jstate = jcls(**{k: jnp.asarray(v) for k, v in fields.items()})
    tstate = tcls(**{k: torch.from_numpy(v) for k, v in fields.items()})
    acts = _random_actions(rng, ta.action_space(), n)
    draw, jkw = None, {}
    if kw["action_space"] == "twap_v3":
        keys = jax.random.split(jax.random.PRNGKey(4), E_MSGS * n).reshape(
            E_MSGS, n, 2)
        k_twap = jax.vmap(jax.vmap(lambda k: jax.random.split(k)[0]))(keys)
        k_ham = jax.vmap(jax.vmap(lambda k: jax.random.split(k)[1]))(keys)
        draw = ExecStepDraw(
            swap=torch.from_numpy(np.array(jax.vmap(jax.vmap(_swap))(
                k_twap))),
            ties=torch.from_numpy(np.array(jax.vmap(jax.vmap(
                lambda k: _uniforms(k, 2)))(k_ham))))
        jkw = dict(key=keys)

    def per_env(a, w, s, k=None):
        if k is None:
            return jax.vmap(lambda a_, s_, p_: ja.get_action_msgs(
                a_, w, s_, p_))(a, s, jp)
        return jax.vmap(lambda a_, s_, p_, k_: ja.get_action_msgs(
            a_, w, s_, p_, key=k_))(a, s, jp, k)

    want = jax.vmap(per_env)(jnp.asarray(acts), jworld, jstate,
                             *(jkw.values()))
    args = (torch.from_numpy(acts), tworld, tstate, tp)
    got = (ta.get_action_msgs(*args, draw) if kind == "exe"
           else ta.get_action_msgs(*args))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got[..., 2] != 0).any() or kw["action_space"] == "twap"


# --------------------------------------------------------------------------
# spaces
# --------------------------------------------------------------------------


def test_spaces_sample_inside_their_bounds():
    """``sample`` draws from the generator inside the JAX bounds: a
    ``Discrete`` and an integer ``Box`` from ``[low, high)``, a float
    ``Box`` from ``[low, high)``; ``contains`` agrees with the JAX spaces'
    on values inside and outside."""
    g = torch.Generator().manual_seed(0)
    d = tspaces.Discrete(3)
    draws = torch.stack([d.sample(g) for _ in range(300)])
    assert draws.dtype == torch.int32 and set(draws.tolist()) == {0, 1, 2}
    ib = tspaces.Box(0, 3, (400,), torch.int32)
    x = ib.sample(g)
    assert x.dtype == torch.int32 and set(x.tolist()) == {0, 1, 2}
    fb = tspaces.Box(torch.tensor([-1.0, 0.0, 0.0]),
                     torch.tensor([1.0, 1.0, 5.0]), (3,))
    xs = torch.stack([fb.sample(g) for _ in range(200)])
    assert xs.dtype == torch.float32
    assert (xs >= fb.low).all() and (xs < fb.high).all()
    dd = tspaces.Dict({"obs": fb, "n": d})
    s = dd.sample(g)
    assert set(s) == {"obs", "n"} and dd.contains(s)
    jd, jfb = jspaces.Discrete(3), jspaces.Box(
        jnp.array([-1.0, 0.0, 0.0]), jnp.array([1.0, 1.0, 5.0]), (3,))
    jdd = jspaces.Dict({"obs": jfb, "n": jd})
    for v in (-1, 0, 2, 3):
        assert d.contains(torch.tensor(v)) == jd.contains(jnp.int32(v))
    for v in ([0.0, 1.0, 5.0], [-1.5, 0.5, 1.0], [1.0, 1.0, 5.01],
              [-1.0, 0.0, 0.0]):
        assert fb.contains(torch.tensor(v)) == jfb.contains(jnp.array(v))
        assert dd.contains({"obs": torch.tensor(v), "n": torch.tensor(1)}) \
            == jdd.contains({"obs": jnp.array(v), "n": jnp.int32(1)})
    assert ib.contains(torch.tensor([0, 3])) and not ib.contains(
        torch.tensor([0, 4]))


def test_world_spaces_sample_actions_the_world_takes(envs):
    _, tenv = envs
    g = torch.Generator().manual_seed(1)
    for sp in tenv.action_space() + tenv.observation_space():
        assert sp.contains(sp.sample(g))


# --------------------------------------------------------------------------
# env/common.py trade-log helpers, env/base.py::state_from_data
# --------------------------------------------------------------------------


def _log(seed):
    from test_trade_summary import random_log
    return random_log(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", range(3))
def test_extract_trade_stats_matches_jax(seed):
    trades = _log(seed)
    want = jcommon.extract_trade_stats(trades, jnp.int32(-42))
    got = tcommon.extract_trade_stats(torch.from_numpy(np.array(trades)),
                                      -42)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)
    batch = tcommon.extract_trade_stats(
        torch.from_numpy(np.stack([np.array(_log(s)) for s in range(3)])),
        torch.tensor([-42, -43, -7]))
    assert batch.buy_quant.shape == (3,)


@pytest.mark.parametrize("seed,q_signed,fill", [
    (0, 17, 20), (1, -9, 32), (2, 120, 0)])
def test_add_artificial_trade_matches_jax(seed, q_signed, fill):
    """Into the first empty row, into the last row of a full log, and
    into an empty log."""
    from test_trade_summary import random_log
    wj, wt = jcfg.WorldConfig(), tcfg.WorldConfig()
    trades = random_log(jax.random.PRNGKey(seed), n_filled=fill)
    time = np.array([35_000, 123], np.int32)
    want = jcommon.add_artificial_trade(wj, trades, jnp.int32(100_300),
                                        jnp.int32(q_signed),
                                        jnp.asarray(time), jnp.int32(-42))
    got = tcommon.add_artificial_trade(
        wt, torch.from_numpy(np.array(trades)), 100_300, q_signed,
        torch.from_numpy(time), -42)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_add_artificial_trade_quirk_without_an_empty_row():
    """A log with a -1 field but no empty row: row 0 is overwritten, as the
    JAX function's ``argmax`` of no empty row gives."""
    trades = np.array(_log(4))
    trades[:, 0] = np.arange(32) + 10
    trades[5, 3] = -1
    wj, wt = jcfg.WorldConfig(), tcfg.WorldConfig()
    want = jcommon.add_artificial_trade(
        wj, jnp.asarray(trades), jnp.int32(1), jnp.int32(2),
        jnp.array([3, 4], jnp.int32), jnp.int32(-42))
    got = tcommon.add_artificial_trade(wt, torch.from_numpy(trades), 1, 2,
                                       torch.tensor([3, 4]), -42)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert int(got[0, 0]) == 1


def test_rolling_mean_and_normalize_obs_dict_match_jax():
    rng = np.random.default_rng(0)
    avg = rng.normal(0, 1e3, (4, 3)).astype(np.float32)
    new = rng.normal(0, 1e3, (4, 3)).astype(np.float32)
    n = rng.integers(0, 500, (4, 1)).astype(np.int32)
    want = np.asarray(jax.jit(jcommon.rolling_mean)(
        jnp.asarray(avg), jnp.asarray(new), jnp.asarray(n)))
    got = tcommon.rolling_mean(torch.from_numpy(avg), torch.from_numpy(new),
                               torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(want, got)
    obs = {"a": rng.normal(0, 5, 3).astype(np.float32),
           "b": np.arange(3, dtype=np.int32)}
    means, stds = {"a": 1.5, "b": 0}, {"a": 2.0, "b": 10}
    want = jcommon.normalize_obs_dict({k: jnp.asarray(v)
                                       for k, v in obs.items()}, means, stds)
    got = tcommon.normalize_obs_dict({k: torch.from_numpy(v)
                                      for k, v in obs.items()}, means, stds)
    for k in obs:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


@pytest.mark.parametrize("ep_type", ["fixed_steps", "fixed_time"])
def test_state_from_data_matches_jax(ep_type):
    """One window of the synthetic day replayed through the XLA-scan
    engine of each package: every field and the trade log equal; the
    port's batched reset table holds the same book."""
    world = dict(WORLD, ep_type=ep_type)
    wj, wt = jcfg.WorldConfig(**world), tcfg.WorldConfig(**world)
    data = j_load_data(wj)
    w = 3
    args = (data.messages[data.starts[w]][[6, 7]], data.init_books[w],
            data.max_msgs_per_window[w] // wj.n_data_msg_per_step + 1, w,
            data.starts[w])
    want = jbase.state_from_data(wj, jax.random.PRNGKey(0),
                                 *[jnp.asarray(a) for a in args])
    got, trades = tbase.state_from_data(wt, *[torch.as_tensor(np.asarray(a))
                                              for a in args])
    book = np.stack([np.stack([np.asarray(getattr(s, f)) for f in (
        "price", "quant", "oid", "tid", "time_s", "time_ns")])
        for s in (want.asks, want.bids)])
    np.testing.assert_array_equal(book, got.book.numpy())
    np.testing.assert_array_equal(np.asarray(want.trades), trades.numpy())
    for f in dataclasses.fields(got):
        if f.name != "book":
            np.testing.assert_array_equal(
                np.asarray(getattr(want, f.name)),
                getattr(got, f.name).numpy(), err_msg=f.name)
    table = tbase.build_init_states(wt, t_load_data(wt), torch.device("cpu"))
    assert torch.equal(table.book[w], got.book)


def test_small_members_of_the_jax_api():
    """``SideState.n`` and ``is_empty`` as the JAX properties give them."""
    from test_torch_env import _random_books
    from vit_marl_tpu_torch.lob import book as tbk

    book = _random_books(np.random.default_rng(2), 3, 24)
    side = tbk.BookState(torch.from_numpy(book)).bids
    jside = jbk.SideState(*[jnp.asarray(book[:, 1, f]) for f in range(6)])
    assert side.n == jside.n == 24
    np.testing.assert_array_equal(np.asarray(jside.is_empty),
                                  side.is_empty.numpy())
