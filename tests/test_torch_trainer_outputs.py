"""The port's trainer outputs against the JAX package's: the env-info and
action metrics (``LOG_ENV_INFO``), the metric logger, checkpoints and
resume.

- ``_reduce_info``, ``_action_metrics`` and ``_fold_info_stats`` of
  ``vit_marl_tpu_torch/rl/ppo.py`` take the same numpy-made arrays as the
  JAX functions (a Discrete and a Box action space; int, bool and float
  info fields of several shapes) and agree within 1e-6 relative.
- ``step_vec``'s info tree matches the JAX world step's on fed draws
  (2-player and vision worlds): the same keys, integer fields equal,
  float fields within the step test's 1e-5.
- A CPU ``make_train`` of one tiny update emits the metric keys of the
  JAX ``make_train`` for the same config, plus the port's two timing keys
  (``rollout_s``, ``update_s``); with ``LOG_ENV_INFO=false`` neither
  emits info or action metrics.
- ``rl/logger.py::Logger`` writes the JAX logger's jsonl lines and print
  lines for the same metrics; ``wandb`` falls back to ``jsonl`` where it
  is not installed.
- ``rl/checkpoint.py::CheckpointManager`` round-trips through
  ``torch.load(weights_only=True)`` and keeps ``max_to_keep`` steps;
  ``make_train`` saves every ``checkpoint_every`` updates and at the last;
  resume restores weights, Adam moments and step counts exactly and
  continues at the latest saved update + 1; a shape change and ``RESUME``
  without ``CHECKPOINT_DIR`` raise.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import (
    E,
    VISION,
    WORLD,
    _actions,
    _env_pair,
    _reset_draws,
    _step_draws,
)
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env import spaces as jspaces
from vit_marl_tpu.rl import logger as jlogger
from vit_marl_tpu.rl import ppo as jppo
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env import spaces as tspaces
from vit_marl_tpu_torch.rl import checkpoint as tckpt
from vit_marl_tpu_torch.rl import logger as tlogger
from vit_marl_tpu_torch.rl import ppo as tppo

REL = dict(rtol=1e-6, atol=1e-6)
TIMING = {"rollout_s", "update_s"}


def _np(tree):
    """Leaves as float64 numpy, for comparing a JAX tree with a port one."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.numpy()
    return np.asarray(tree, np.float64)


def _assert_tree_close(want, got, name="", **tol):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), name
        for k in want:
            _assert_tree_close(want[k], got[k], f"{name}/{k}", **tol)
    elif isinstance(want, list):
        assert len(want) == len(got), name
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_tree_close(a, b, f"{name}[{i}]", **tol)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _info(rng, n_steps=1):
    """An info tree of int, bool and float fields of several shapes."""
    def agent():
        return {"reward": rng.normal(size=(E, 2)).astype(np.float32) * 30,
                "done": rng.random((E, 2)) < 0.4,
                "quant_left": rng.integers(0, 500, (E, 2)).astype(np.int32),
                "total_PnL": rng.normal(size=(E, 2)).astype(np.float32)}
    return {"agents": [agent(), agent()],
            "world": {"time": rng.integers(34_200, 57_600, (E, 2)).astype(
                          np.int32),
                      "end_mid_price": rng.normal(
                          2_200_000, 500, E).astype(np.float32),
                      "step_counter": rng.integers(0, 9, E).astype(np.int32)}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def test_reduce_info_matches_jax():
    rng = np.random.default_rng(0)
    info = _info(rng)
    want = jppo._reduce_info(_to(info, jnp.asarray))
    got = tppo._reduce_info(_to(info, torch.from_numpy))
    _assert_tree_close(_np(want), _np(got), **REL)


@pytest.mark.parametrize("space", ["discrete", "box"])
def test_action_metrics_match_jax(space):
    rng = np.random.default_rng(1)
    T, A = 5, 12
    if space == "discrete":
        # one id never drawn: its percentage is 0, as bincount(length=n)
        action = rng.integers(0, 6, (T, A)).astype(np.int32)
        action[action == 4] = 5
        jsp, tsp = jspaces.Discrete(7), tspaces.Discrete(7)
    else:
        action = rng.normal(size=(T, A, 3)).astype(np.float32)
        low, high = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
        jsp = jspaces.Box(low, high, (3,))
        tsp = tspaces.Box(torch.from_numpy(low), torch.from_numpy(high), (3,))
    want, got = {}, {}
    jppo._action_metrics(jnp.asarray(action), jsp, "EXE", want)
    tppo._action_metrics(torch.from_numpy(action), tsp, "EXE", got)
    _assert_tree_close(_np(want), _np(got), **REL)
    if space == "box":   # the population std, as jnp.std
        np.testing.assert_allclose(got["EXE/action_std"].item(),
                                   action.std(), rtol=1e-6)


def test_fold_info_stats_matches_jax():
    """Stacked per-step moments, one field whose variance rounds below 0
    (a constant field: the clamp at 0)."""
    rng = np.random.default_rng(2)
    steps = [_info(rng) for _ in range(6)]
    for s in steps:
        s["agents"][0]["constant"] = np.full((E, 2), 0.1, np.float32)
    jst = [jppo._reduce_info(_to(s, jnp.asarray)) for s in steps]
    tst = [tppo._reduce_info(_to(s, torch.from_numpy)) for s in steps]
    jstack = jax.tree.map(lambda *v: jnp.stack(v), *jst)
    tstack = {"agents": [{k: torch.stack([s["agents"][i][k] for s in tst])
                          for k in tst[0]["agents"][i]} for i in range(2)],
              "world": {k: torch.stack([s["world"][k] for s in tst])
                        for k in tst[0]["world"]}}
    want, got = {}, {}
    jppo._fold_info_stats(jstack, ["MM", "EXE"], want)
    tppo._fold_info_stats(tstack, ["MM", "EXE"], got)
    _assert_tree_close(_np(want), _np(got), **REL)
    assert got["MM/info_constant_std"].item() == 0.0


def _info_pairs(jenv, tenv, n_steps):
    """The two worlds' info trees over ``n_steps`` steps on fed draws."""
    jp, tp = jenv.default_params, tenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    _, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jp)
    _, tst = tenv.reset(_reset_draws(jenv, keys), tp)
    rng = np.random.default_rng(n_steps)
    key = jax.random.PRNGKey(100 + n_steps)
    for _ in range(n_steps):
        key, sk = jax.random.split(key)
        acts = [_actions(rng, sp, n)
                for sp, n in zip(tenv.action_spaces, tenv.n_per_type)]
        _, jst, _, _, jinfo = jenv.step_vec(
            sk, jst, [jnp.asarray(a) for a in acts], jp)
        _, tst, _, _, tinfo = tenv.step_vec(
            tst, [torch.from_numpy(a) for a in acts], tp,
            draws=_step_draws(jenv, sk))
        yield jinfo, tinfo


@pytest.mark.parametrize("world", ["2-player", "vision"])
def test_step_info_tree_matches_jax(world):
    exe = dict(VISION) if world == "vision" else None
    jenv, tenv = _env_pair(exe=exe)
    for jinfo, tinfo in _info_pairs(jenv, tenv, 3):
        # the jitted JAX step returns its dicts with sorted keys
        assert sorted(jinfo) == sorted(tinfo) == ["agents", "world"]
        assert sorted(jinfo["world"]) == sorted(tinfo["world"])
        assert len(jinfo["agents"]) == len(tinfo["agents"]) == 2
        for ja, ta in zip(jinfo["agents"], tinfo["agents"]):
            assert sorted(ja) == sorted(ta)
        for name, j, t in [("world", jinfo["world"], tinfo["world"])] + [
                (f"agent {i}", a, b) for i, (a, b) in enumerate(
                    zip(jinfo["agents"], tinfo["agents"]))]:
            for k in j:
                want, got = np.asarray(j[k]), t[k].numpy()
                assert want.shape == got.shape, (name, k)
                if np.issubdtype(want.dtype, np.integer) or \
                        want.dtype == bool:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{name} {k}")
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-5,
                                               err_msg=f"{name} {k}")
        _assert_tree_close(_np(jppo._reduce_info(jinfo)),
                           _np(tppo._reduce_info(tinfo)), rtol=1e-5,
                           atol=1e-5)


def _train_configs(world, **kw):
    fields = dict(num_envs=4, num_steps=4, update_epochs=1,
                  num_minibatches=2, total_timesteps=16, log_backend="none")
    agents = ()
    if world == "vision":
        fields.update(network=("gru", "vit_gru"), vit_preset="micro")
        agents = (VISION,)
    fields.update(kw)
    out = []
    for c in (jcfg, tcfg):
        ag = (c.MarketMakingConfig(), c.ExecutionConfig(**agents[0])) \
            if agents else (c.MarketMakingConfig(), c.ExecutionConfig())
        out += [c.MultiAgentConfig(world=c.WorldConfig(**WORLD), agents=ag),
                c.TrainConfig(**fields)]
    return out


@pytest.mark.parametrize("world", ["2-player", "vision"])
def test_make_train_emits_the_jax_metric_keys(world):
    jma, jtc, tma, ttc = _train_configs(world)
    want = jppo.make_train(jma, jtc)(jax.random.PRNGKey(0))["metrics"][0]
    got = tppo.make_train(tma, ttc, device="cpu")(seed=0)["metrics"][0]
    assert [k for k in got if k not in TIMING] == list(want)
    assert any("/info_" in k for k in got)
    assert any(k.startswith("world/") for k in got)
    action_key = "EXE/action_mean" if world == "vision" \
        else "EXE/action_pct_0"
    assert action_key in got
    assert all(np.isfinite(v) for v in got.values())
    # a percentage of each action id: they sum to 100
    np.testing.assert_allclose(
        sum(v for k, v in got.items() if k.startswith("MM/action_pct_")),
        100.0, rtol=1e-5)


def test_make_train_without_env_info():
    _, _, tma, ttc = _train_configs("2-player", log_env_info=False)
    got = tppo.make_train(tma, ttc, device="cpu")(seed=0)["metrics"][0]
    assert not any("/info_" in k or "/action_" in k or
                   k.startswith("world/") for k in got)
    assert {"MM/total_loss", "EXE/total_loss"} <= set(got)


# --------------------------------------------------------------------------
# logger
# --------------------------------------------------------------------------

def _metrics():
    return {"update_step": 3, "MM/mean_reward": np.float32(1.25),
            "EXE/entropy": 0.5, "world/time_mean": 45_000.5,
            "vec": [1.0, 2.0, 3.5], "flag": True}


def test_logger_jsonl_lines_equal_jax(tmp_path):
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jl, tl = jlogger.Logger("jsonl", jpath), tlogger.Logger("jsonl", tpath)
    m = _metrics()
    jl.log({k: jnp.asarray(v) for k, v in m.items()})
    jl.log(m)
    tl.log({k: torch.tensor(v) for k, v in m.items()})
    tl.log(m)
    with open(jpath) as f, open(tpath) as g:
        assert f.read() == g.read()


def test_logger_print_and_fallback_match_jax(tmp_path, capsys):
    m = _metrics()
    jlogger.Logger("print").log(m)
    want = capsys.readouterr().out
    tlogger.Logger("print").log({k: torch.tensor(v) for k, v in m.items()})
    assert capsys.readouterr().out == want
    tlogger.Logger("none").log(m)
    assert capsys.readouterr().out == ""
    try:
        import wandb  # noqa: F401
    except ImportError:
        assert tlogger.Logger("wandb").backend == \
            jlogger.Logger("wandb").backend == "jsonl"


def test_make_train_jsonl_lines_equal_jax_logger(tmp_path):
    """``LOG_BACKEND=jsonl``: the trainer's lines are the JAX logger's
    lines for the same metrics."""
    path = str(tmp_path / "m.jsonl")
    _, _, tma, ttc = _train_configs("2-player", log_backend="jsonl",
                                    log_path=path, total_timesteps=32)
    out = tppo.make_train(tma, ttc, device="cpu")(seed=0)
    jl = jlogger.Logger("jsonl", str(tmp_path / "j.jsonl"))
    for m in out["metrics"]:
        jl.log(m)
    with open(path) as f, open(tmp_path / "j.jsonl") as g:
        lines = f.read()
        assert lines == g.read()
    assert [json.loads(x)["update_step"] for x in lines.splitlines()] == \
        [0, 1]


# --------------------------------------------------------------------------
# checkpoints and resume
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, eps=1e-5)
    net(torch.ones(4, 3)).sum().backward()
    opt.step()
    for step in range(5):
        mgr.save(step, [net.state_dict()], metrics={"loss": step + 0.5},
                 opt_states=[tckpt.adam_state(opt)], train_steps=[step])
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    got = mgr.restore()
    raw = torch.load(tmp_path / "4" / tckpt.FILE, weights_only=True)
    assert raw.keys() == got.keys() == {"params", "metrics", "opt", "count"}
    for k, v in net.state_dict().items():
        assert torch.equal(got["params"][0][k], v)
    assert got["metrics"] == {"loss": 4.5} and got["count"] == [4]
    for k in ("exp_avg", "exp_avg_sq"):
        for a, p in zip(got["opt"][0][k], net.parameters()):
            assert torch.equal(a, opt.state[p][k])
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore()


def test_keep_period_keeps_the_steps_the_jax_manager_keeps(tmp_path):
    """Steps 0-9 saved with ``max_to_keep=2, keep_period=3``: the port's
    manager keeps the steps the JAX (orbax) manager keeps; ``close`` is
    idempotent and a save after it raises."""
    from vit_marl_tpu.rl.checkpoint import CheckpointManager as JManager

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm = JManager(jdir, max_to_keep=2, keep_period=3)
    tm = tckpt.CheckpointManager(tdir, max_to_keep=2, keep_period=3)
    net = torch.nn.Linear(2, 1)
    opt = torch.optim.Adam(net.parameters())
    for step in range(10):
        jm.save(step, [{"w": np.full(2, step, np.float32)}])
        tm.save(step, [net.state_dict()], [tckpt.adam_state(opt)], [step])
    jm.close()
    kept = sorted(int(d) for d in os.listdir(jdir) if d.isdigit())
    assert tm.all_steps() == kept
    assert 0 in kept and 3 in kept and 1 not in kept
    tm.close()
    tm.close()
    with pytest.raises(RuntimeError, match="closed"):
        tm.save(10, [net.state_dict()], [tckpt.adam_state(opt)], [10])
    assert tm.all_steps() == kept and tm.restore()["count"] == [9]


def test_make_train_closes_its_checkpoint_manager(tmp_path, monkeypatch):
    closed = []
    close = tckpt.CheckpointManager.close

    def recording(self):
        closed.append(self)
        close(self)

    monkeypatch.setattr(tckpt.CheckpointManager, "close", recording)
    _, _, tma, ttc = _train_configs("2-player",
                                    checkpoint_dir=str(tmp_path))
    tppo.make_train(tma, ttc, device="cpu")(seed=0)
    assert len(closed) == 1 and closed[0].all_steps() == [0]
    with pytest.raises(RuntimeError, match="closed"):
        closed[0].save(1, [], [], [])


def test_make_train_saves_every_k_and_the_last(tmp_path):
    _, _, tma, ttc = _train_configs(
        "2-player", total_timesteps=80, checkpoint_dir=str(tmp_path),
        checkpoint_every=2, checkpoint_max_to_keep=10)
    assert ttc.num_updates == 5
    tppo.make_train(tma, ttc, device="cpu")(seed=0)
    assert tckpt.CheckpointManager(str(tmp_path)).all_steps() == [1, 3, 4]


def _state(learners):
    out = []
    for lr in learners:
        st = {k: v.clone() for k, v in lr.net.state_dict().items()}
        adam = tckpt.adam_state(lr.opt)
        out.append((st, {k: [t.clone() for t in v] for k, v in adam.items()},
                    lr.count))
    return out


@pytest.mark.parametrize("world", ["2-player", "vision"])
def test_resume_restores_exactly_and_continues(tmp_path, world):
    _, _, tma, ttc = _train_configs(
        world, total_timesteps=48, checkpoint_dir=str(tmp_path))
    assert ttc.num_updates == 3
    first = tppo.make_train(tma, ttc, device="cpu")(seed=0, n_updates=2)
    assert [m["update_step"] for m in first["metrics"]] == [0, 1]
    saved = _state(first["learners"])
    assert saved[0][2] == 4      # two minibatch steps an update

    resumed = dataclasses.replace(ttc, resume=True)
    train = tppo.make_train(tma, resumed, device="cpu")
    # the entry point's restore alone: no update run
    restored = train(seed=0, n_updates=0)
    assert restored["metrics"] == []
    for (w0, a0, c0), (w1, a1, c1) in zip(saved,
                                          _state(restored["learners"])):
        assert c0 == c1
        for k in w0:
            assert torch.equal(w0[k], w1[k]), k
        for k in a0:
            for x, y in zip(a0[k], a1[k]):
                assert torch.equal(x, y), k
    # the whole run continues after the latest checkpoint
    out = train(seed=0)
    assert [m["update_step"] for m in out["metrics"]] == [2]
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    assert tckpt.CheckpointManager(str(tmp_path)).all_steps() == [1, 2]


def test_resume_raises_on_a_shape_change(tmp_path):
    _, _, tma, ttc = _train_configs("2-player",
                                    checkpoint_dir=str(tmp_path))
    tppo.make_train(tma, ttc, device="cpu")(seed=0)
    other = dataclasses.replace(ttc, resume=True, fc_dim=32, hidden_size=32)
    with pytest.raises(ValueError, match="shape"):
        tppo.make_train(tma, other, device="cpu")(seed=0)


def test_resume_without_a_directory_raises():
    _, _, tma, ttc = _train_configs("2-player", resume=True)
    with pytest.raises(ValueError, match="CHECKPOINT_DIR"):
        tppo.make_train(tma, ttc, device="cpu")
