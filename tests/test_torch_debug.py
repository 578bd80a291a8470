"""The ``debug_mode`` world step of the port against the JAX package's, and
against the port's own aggregate route.

``debug_mode`` runs the book scan in records mode, builds the step's trade
log, carries it in the world state and ``info["world"]``, and reads the
rewards' trade sums from it.  On the CPU the JAX package builds that log
with its uncapped XLA scan; the port records ``REC_K`` = 16 fills per
message in cancel modes 0 and 1 and every fill in modes 2 and 3.  So the
two agree wherever no message fills more than 16 resting orders, which
the tests check as well as the results.  States, the trade log included,
are equal; rewards and observations agree within 1e-5 as in
``tests/test_torch_env.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env import world as tworld
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.ops import book_kernel as bkern

from test_torch_env import (
    E,
    WORLD,
    _actions,
    _assert_close,
    _assert_state_equal,
    _reset_draws,
    _step_draws,
)


def _debug_pair(mode):
    world = dict(WORLD, debug_mode=True, cancel_mode=mode)
    jenv = JWorldEnv(jcfg.MultiAgentConfig(world=jcfg.WorldConfig(**world)))
    tenv = WorldEnv(tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**world)),
                    device="cpu")
    return jenv, tenv


@pytest.fixture
def fill_counts(monkeypatch):
    """Every ``fill_counts`` the world's records scans return."""
    seen = []

    def spy(*args, **kw):
        out = bkern.process_step_records(*args, **kw)
        seen.append(out[2][1])
        return out

    monkeypatch.setattr(tworld, "process_step_records", spy)
    return seen


@pytest.mark.parametrize("mode", [1, 2])
def test_debug_step_vec_matches_jax(mode, fill_counts):
    jenv, tenv = _debug_pair(mode)
    assert tenv.rec_k == (16 if mode < 2 else tenv.wcfg.n_orders)
    jp, tp = jenv.default_params, tenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(21), E)
    jobs, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jp)
    tobs, tst = tenv.reset(_reset_draws(jenv, keys), tp)
    assert (tst.world.trades == -1).all()
    _assert_state_equal(jst, tst)
    rng = np.random.default_rng(mode)
    key = jax.random.PRNGKey(200 + mode)
    saw_reset, n_logged = False, 0
    for t in range(4):
        key, sk = jax.random.split(key)
        acts = [_actions(rng, sp, n)
                for sp, n in zip(tenv.action_spaces, tenv.n_per_type)]
        jobs, jst, jrew, jdone, jinfo = jenv.step_vec(
            sk, jst, [jnp.asarray(a) for a in acts], jp)
        tobs, tst, trew, tdone, tinfo = tenv.step_vec(
            tst, [torch.from_numpy(a) for a in acts], tp,
            draws=_step_draws(jenv, sk))
        _assert_state_equal(jst, tst)
        for i in range(2):
            _assert_close(jobs[i], tobs[i], f"step {t} obs {i}")
            _assert_close(jrew[i], trew[i], f"step {t} reward {i}")
            np.testing.assert_array_equal(np.asarray(jdone["agents"][i]),
                                          tdone["agents"][i].numpy())
        for k in ("trades", "total_msgs", "lob_state"):
            np.testing.assert_array_equal(np.asarray(jinfo["world"][k]),
                                          tinfo["world"][k].numpy(),
                                          err_msg=k)
        n_logged += int((tinfo["world"]["trades"][:, :, 0] != -1).sum())
        saw_reset |= bool(tdone["__all__"].any())
    assert saw_reset, "the episode boundary was not crossed"
    assert n_logged > 0, "no step logged a trade"
    # the JAX package's CPU log is uncapped: no message may exceed REC_K
    assert len(fill_counts) == 4
    assert max(int(c.max()) for c in fill_counts) <= bkern.REC_K


def test_debug_and_aggregate_routes_give_equal_rewards(fill_counts):
    """From one state and one set of draws, the debug route (sums from the
    trade log) and the aggregate route (sums from the scan) give equal
    rewards in every env whose fills fit the log."""
    world = dict(WORLD, cancel_mode=1)
    envs = [WorldEnv(tcfg.MultiAgentConfig(world=tcfg.WorldConfig(
        **world, debug_mode=d)), device="cpu") for d in (False, True)]
    gen = torch.Generator().manual_seed(3)
    params = envs[0].default_params
    _, state = envs[0].reset(envs[0].draw_reset(E, gen), params)
    dstate = dataclasses.replace(state, world=state.world.replace(
        trades=torch.full((E, envs[1].wcfg.n_trades, 8), -1,
                          dtype=torch.int32)))
    compared = 0
    for t in range(3):
        draws = envs[0].draw_step(E, gen)
        acts = [torch.randint(0, sp.n, (E,), generator=gen)
                for sp in envs[0].action_spaces]
        _, state, rew, _, _ = envs[0].step_vec(state, acts, params, draws)
        _, dstate, drew, _, dinfo = envs[1].step_vec(dstate, acts, params,
                                                     draws)
        fits = fill_counts[-1].sum(dim=1) <= envs[1].wcfg.n_trades
        for r, d in zip(rew, drew):
            assert torch.equal(r[fits], d[fits])
        assert torch.equal(state.world.book, dstate.world.book)
        compared += int(fits.sum())
    assert compared > 0
