"""The port's evaluation against the JAX package's: the trainer's greedy
eval, the baseline policies, the Learned/Baseline combinations and the
``evaluate`` entry point.

- ``rl/ppo.py::eval_rollout`` against the JAX trainer's ``_eval_rollout``
  (``vit_marl_tpu/rl/ppo.py:668-716``, a closure of ``make_train``, so its
  body is replayed here from the JAX functions it calls) on the same GRU
  weights (``models/bridge.py``) and the JAX draws: mean rewards within
  1e-5, the action and info metrics within 1e-5 relative.
- ``eval/combinations.py::rollout`` in ``greedy`` mode against the JAX
  ``rollout`` on bridged weights and replayed draws, on the canonical
  baseline world (MM ``AvSt``, execution ``twap``): rewards, actions,
  dones and infos of every step.  ``sample`` mode: a uniform policy's
  actions are uniform, a fixed one's fixed.
- The baselines' distributions, ``evaluate_combinations``'s labels, the
  eval metric keys of ``make_train`` with ``EVAL_EVERY`` (equal to the
  JAX ``make_train``'s, ``tests/test_ppo.py:160-190``), the held-out
  eval world, and ``python -m vit_marl_tpu_torch.evaluate --device cpu``
  end to end: ``combinations.json`` and the plots; from a checkpoint of
  the port's trainer; without matplotlib; and its refusal without a card.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import E, WORLD, _assert_close, _reset_draws, _step_draws
from test_torch_spaces import _agent_draws
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu.eval import baselines as jbase
from vit_marl_tpu.eval import combinations as jcomb
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.rl import ppo as jppo
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch import evaluate as tevaluate
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.eval import baselines as tbase
from vit_marl_tpu_torch.eval import combinations as tcomb
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.rl import ppo as tppo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
BASELINE_AGENTS = dict(
    mm=dict(action_space="AvSt"),
    exe=dict(action_space="twap", observation_space="simplest_case",
             reward_space="simplest_case"))


def _pair(baseline=True):
    out = []
    for c in (jcfg, tcfg):
        agents = (c.MarketMakingConfig(**BASELINE_AGENTS["mm"]),
                  c.ExecutionConfig(**BASELINE_AGENTS["exe"]))
        out.append(c.MultiAgentConfig(world=c.WorldConfig(**WORLD),
                                      agents=agents))
    return JWorldEnv(out[0]), WorldEnv(out[1], device="cpu")


@pytest.fixture(scope="module")
def worlds():
    return {"baseline": _pair(baseline=True)}


def _networks(jenv, seed=0):
    """JAX GRU networks of each type, their params, and the port's on the
    same weights."""
    tc_j, tc_t = jcfg.TrainConfig(), tcfg.TrainConfig()
    jnets, params, tnets = [], [], []
    for i, (asp, osp) in enumerate(zip(jenv.action_spaces,
                                       jenv.observation_spaces)):
        jnet = jppo.make_network(tc_j, i, asp, osp)
        p = jax.jit(jnet.init)(jax.random.PRNGKey(seed + i),
                      JScannedGRU.initialize_carry(E, tc_j.hidden_size),
                      (jnp.zeros((1, E) + tuple(osp.shape)),
                       jnp.zeros((1, E), bool)))
        tnet = tppo.ActorCriticRNN(int(osp.shape[0]), int(asp.n),
                                   tc_t.fc_dim, tc_t.hidden_size)
        tnet.load_state_dict(flax_to_state_dict(jax.device_get(p)))
        jnets.append(jnet)
        params.append(p)
        tnets.append(tnet)
    return jnets, params, tnets


def _draws(jenv, key):
    d = _step_draws(jenv, key)
    _, key_step, _ = jax.random.split(key, 3)
    d.agents = _agent_draws(jenv, jax.random.split(key_step, E))
    return d


def _jax_eval(jenv, jnets, params, rng, steps):
    """The JAX trainer's ``_eval_rollout`` (ppo.py:668-716), step for step,
    with the draws the port is fed."""
    n_types = len(jenv.agent_types)
    actors = [n * E for n in jenv.n_per_type]
    ep = jenv.default_params
    rng, r0 = jax.random.split(rng)
    keys0 = jax.random.split(r0, E)
    obs, st = jax.vmap(jenv.reset, in_axes=(0, None))(keys0, ep)
    hs = [JScannedGRU.initialize_carry(actors[i], 64) for i in range(n_types)]
    dns = [jnp.zeros((actors[i],), bool) for i in range(n_types)]
    rews, stats, acts, step_draws = [], [], [[] for _ in range(n_types)], []
    for _ in range(steps):
        rng, kstep = jax.random.split(rng)
        step_acts = []
        for i in range(n_types):
            obs_i = obs[i].reshape((actors[i],) + obs[i].shape[2:])[None]
            hs[i], pi, _ = jnets[i].apply(params[i], hs[i],
                                          (obs_i, dns[i][None]))
            a = pi.mode()[0].reshape((E, jenv.n_per_type[i]))
            acts[i].append(a)
            step_acts.append(a.squeeze())
        step_draws.append(_draws(jenv, kstep))
        obs, st, rew, done, infos = jenv.step_vec(kstep, st, step_acts, ep)
        dns = [done["agents"][i].reshape((actors[i],))
               for i in range(n_types)]
        rews.append([r.mean() for r in rew])
        stats.append(jppo._reduce_info(infos))
    names = [a.cfg.short_name for a in jenv.agent_types]
    out = {f"{names[i]}/eval_mean_reward": jnp.stack([r[i] for r in rews]
                                                     ).mean()
           for i in range(n_types)}
    for i in range(n_types):
        jppo._action_metrics(jnp.stack(acts[i]), jenv.action_spaces[i],
                             f"eval_{names[i]}", out)
    jppo._fold_info_stats(jax.tree.map(lambda *v: jnp.stack(v), *stats),
                          names, out, prefix="eval_")
    return out, (_reset_draws(jenv, keys0), step_draws)


def test_greedy_eval_rollout_matches_jax(worlds):
    jenv, tenv = worlds["baseline"]
    jnets, params, tnets = _networks(jenv)
    want, draws = _jax_eval(jenv, jnets, params, jax.random.PRNGKey(5),
                            STEPS)
    got = tppo.eval_rollout(tenv, tnets, E, STEPS, 64, True, draws=draws)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _jax_rollout_draws(jenv, rng, steps):
    """The draws of the JAX ``rollout`` (combinations.py:40-53)."""
    reset = _reset_draws(jenv, jax.random.split(rng, E))
    step = []
    for _ in range(steps):
        rng, _, kstep = jax.random.split(rng, 3)
        step.append(_draws(jenv, kstep))
    return reset, step


def test_greedy_combination_rollout_matches_jax(worlds):
    jenv, tenv = worlds["baseline"]
    jnets, params, tnets = _networks(jenv, seed=3)
    n = [sp.n for sp in jenv.action_spaces]
    jpol = [jbase.LearnedPolicy(jnets[0], params[0]),
            jbase.FixedActionPolicy(0, n_actions=n[1])]
    tpol = [tbase.LearnedPolicy(tnets[0]),
            tbase.FixedActionPolicy(0, n_actions=n[1])]
    rng = jax.random.PRNGKey(9)
    want = jcomb.rollout(jenv, jenv.default_params, jpol, E, STEPS, rng,
                         mode="greedy")
    got = tcomb.rollout(tenv, tenv.default_params, tpol, E, STEPS,
                        mode="greedy",
                        draws=_jax_rollout_draws(jenv, rng, STEPS))
    np.testing.assert_array_equal(np.asarray(want["dones"]),
                                  got["dones"].numpy())
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(want["actions"][i]),
                                      got["actions"][i].numpy())
        _assert_close(want["rewards"][i], got["rewards"][i], f"reward {i}")
        for k, v in want["agent_infos"][i].items():
            _assert_close(v, got["agent_infos"][i][k], f"info {i} {k}")
    for k, v in want["world_infos"].items():
        _assert_close(v, got["world_infos"][k], f"world {k}")
    assert bool(got["dones"].any()), "no episode ended"


def test_sample_mode_draws_from_the_distributions(worlds):
    """A uniform policy's sampled actions are uniform over its ids; a fixed
    policy's always its action; greedy rollouts repeat."""
    _, tenv = worlds["baseline"]
    n = [sp.n for sp in tenv.action_spaces]
    pols = [tbase.RandomPolicy(n[0]), tbase.FixedActionPolicy(0, n[1])]
    gen = torch.Generator().manual_seed(1)
    traj = tcomb.rollout(tenv, tenv.default_params, pols, 256, 2, gen,
                         mode="sample")
    freq = torch.bincount(traj["actions"][0].reshape(-1), minlength=n[0])
    np.testing.assert_allclose((freq / freq.sum()).numpy(), 1 / n[0],
                               atol=0.03)
    assert (traj["actions"][1] == 0).all()
    runs = [tcomb.rollout(tenv, tenv.default_params, pols, E, 2,
                          torch.Generator().manual_seed(4), mode="greedy")
            for _ in range(2)]
    for a, b in zip(runs[0]["rewards"], runs[1]["rewards"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        tcomb.rollout(tenv, tenv.default_params, pols, E, 1, gen,
                      mode="argmax")


@pytest.mark.parametrize("kind", ["fixed", "random", "box"])
def test_baseline_policies_match_jax(kind):
    """Same values, log-probs and entropies as the JAX baselines on a
    (1, 6) batch; the hidden state passes through."""
    obs, dones = np.zeros((1, 6, 3), np.float32), np.zeros((1, 6), bool)
    if kind == "fixed":
        jp, tp = jbase.FixedActionPolicy(2, 5), tbase.FixedActionPolicy(2, 5)
    elif kind == "random":
        jp, tp = jbase.RandomPolicy(4), tbase.RandomPolicy(4)
    else:
        v = np.array([0.5, -1.0, 2.0], np.float32)
        jp = jbase.FixedActionPolicy(v, continuous=True)
        tp = tbase.FixedActionPolicy(v, continuous=True)
    h = torch.ones(6, 8)
    _, jpi, jv = jp.apply(None, None, (jnp.asarray(obs), jnp.asarray(dones)))
    th, tpi, tv = tp(h, torch.from_numpy(obs), torch.from_numpy(dones))
    assert th is h and tuple(tv.shape) == tuple(jv.shape) == (1, 6)
    np.testing.assert_array_equal(tpi.mode().numpy(), np.asarray(jpi.mode()))
    np.testing.assert_allclose(tpi.entropy().numpy(),
                               np.asarray(jpi.entropy()), atol=1e-6)
    a = tpi.sample(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tpi.log_prob(a).numpy(),
                               np.asarray(jpi.log_prob(jnp.asarray(
                                   a.numpy()))), atol=1e-6)
    if kind != "random":
        np.testing.assert_array_equal(a.numpy(), np.asarray(jpi.mode()))


def test_evaluate_combinations_labels(worlds):
    _, tenv = worlds["baseline"]
    n = [sp.n for sp in tenv.action_spaces]
    res = tcomb.evaluate_combinations(
        tenv, tenv.default_params,
        [tbase.RandomPolicy(n[0]), tbase.RandomPolicy(n[1])],
        [tbase.FixedActionPolicy(3, n[0]), tbase.FixedActionPolicy(0, n[1])],
        E, 3, torch.Generator().manual_seed(0))
    assert list(res) == ["LL", "LB", "BL", "BB"]
    for r in res.values():
        assert len(r["mean_rewards"]) == 2
        assert np.isfinite(r["mean_rewards"]).all()
        assert 0 <= r["episode_done_frac"] <= 1
        assert tuple(r["traj"]["rewards"][0].shape) == (3, E, 1)


def _train_pair(**kw):
    fields = dict(num_envs=4, num_steps=4, update_epochs=1,
                  num_minibatches=2, total_timesteps=16, log_backend="none",
                  eval_every=1, eval_steps=3, eval_envs=4)
    fields.update(kw)
    return [(c.MultiAgentConfig(world=c.WorldConfig(**WORLD)),
             c.TrainConfig(**fields)) for c in (jcfg, tcfg)]


def test_make_train_eval_metric_keys_match_jax():
    (jma, jtc), (tma, ttc) = _train_pair()
    want = jppo.make_train(jma, jtc)(jax.random.PRNGKey(0))["metrics"][0]
    train = tppo.make_train(tma, ttc, device="cpu")
    got = train(seed=0)["metrics"][0]
    assert [k for k in got if k not in ("rollout_s", "update_s")] == \
        list(want)
    for name in ("MM", "EXE"):
        assert np.isfinite(got[f"{name}/eval_mean_reward"])
        np.testing.assert_allclose(
            sum(v for k, v in got.items()
                if k.startswith(f"eval_{name}/action_pct_")), 100.0,
            rtol=1e-5)
    assert "eval_world/end_mid_price_mean" in got
    # the held-out world: the next synthetic day
    assert train.eval_env.wcfg.seed == tma.world.seed + 1
    assert not torch.equal(train.eval_env.default_params.world.message_data,
                           train.env.default_params.world.message_data)
    (_, _), (tma, ttc) = _train_pair(log_env_info=False)
    got = tppo.make_train(tma, ttc, device="cpu")(seed=0)["metrics"][0]
    assert not any(k.startswith("eval_") for k in got)
    assert "EXE/eval_mean_reward" in got


def test_eval_world_of_lobster_data(capsys):
    """LOBSTER data needs EVAL_TIME_PERIOD, or EVAL_ALLOW_IN_SAMPLE with a
    warning (ref: ppo.py:202-214)."""
    (_, _), (tma, ttc) = _train_pair()
    lob = dataclasses.replace(tma, world=dataclasses.replace(
        tma.world, data_path="/nonexistent"))
    env = WorldEnv(tma, device="cpu")
    with pytest.raises(ValueError, match="EVAL_TIME_PERIOD"):
        tppo.make_eval_env(lob, ttc, env)
    assert tppo.make_eval_env(lob, dataclasses.replace(
        ttc, eval_allow_in_sample=True), env) is env
    assert "in-sample" in capsys.readouterr().err
    seeded = tppo.make_eval_env(tma, dataclasses.replace(
        ttc, eval_data_seed=7), env)
    assert seeded.wcfg.seed == 7


EVAL_SETS = ["--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4",
             "--set", "NUM_MINIBATCHES=2", "--set", "TOTAL_TIMESTEPS=16",
             "--set", "WORLD.N_ORDERS=64",
             "--set", "WORLD.N_MESSAGES_PER_SYNTHETIC_DAY=4000",
             "--set", "WORLD.EPISODE_TIME=2",
             "--set", "WORLD.START_RESOLUTION=5"]


def test_evaluate_cli_on_the_cpu(tmp_path):
    """``python -m vit_marl_tpu_torch.evaluate --device cpu`` on the
    ``twap`` execution baseline alone: the JSON of both labels and the
    plots (one agent type: the heatmap falls back to the bar plot)."""
    out = tmp_path / "eval"
    args = [sys.executable, "-m", "vit_marl_tpu_torch.evaluate",
            "--device", "cpu", "--num-envs", "4", "--num-steps", "3",
            "--out-dir", str(out), "--episode-plot-envs", "1", "--config",
            os.path.join(ROOT, "configs", "ippo_simplest_case.yaml"),
            "--set", "AGENT_CONFIGS.Execution.ACTION_SPACE=twap"]
    run = subprocess.run(args + EVAL_SETS, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    res = json.loads((out / "combinations.json").read_text())
    assert sorted(res) == ["B", "L"]
    assert all(np.isfinite(r["mean_rewards"]).all() for r in res.values())
    names = {p.name for p in out.iterdir()}
    assert {"heatmap_EXE.png", "triangular_EXE.png"} <= names
    for label in res:
        assert (out / f"episodes_{label}" / "rewards.png").stat().st_size
        assert (out / f"episodes_{label}" / "world.png").stat().st_size


def test_plots_of_two_types_and_learning_curves(tmp_path):
    """The 2x2 heatmap, the bar plot, and the learning curves of a jsonl
    log with eval points (resumed updates logged twice keep the last)."""
    from vit_marl_tpu_torch.eval import plotting

    res = {c: {"mean_rewards": [i + 0.5, -i]}
           for i, c in enumerate(["LL", "LB", "BL", "BB"])}
    for f in (plotting.combination_heatmap, plotting.triangular_plot):
        path = tmp_path / f"{f.__name__}.png"
        f(res, 1, **({"agent_names": ("MM", "EXE")}
                     if f is plotting.combination_heatmap else {}),
          save_path=str(path))
        assert path.stat().st_size > 0
    log = tmp_path / "m.jsonl"
    rows = [{"update_step": u, "MM/mean_reward": float(u),
             "EXE/mean_reward": -float(u), "EXE/eval_mean_reward": 1.0}
            for u in (0, 1, 2, 1, 2, 3)]
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    fig = plotting.learning_curves(str(log), save_path=str(tmp_path / "c.png"),
                                   smooth=2)
    assert len(fig.axes) == 2 and (tmp_path / "c.png").stat().st_size > 0


def test_evaluate_from_a_checkpoint_without_matplotlib(tmp_path, monkeypatch,
                                                       capsys):
    """The learned policies come from the port's trainer's checkpoint;
    without matplotlib the JSON and the episode series are written and one
    line on stderr names the figures left out."""
    ckpt = tmp_path / "ckpt"
    argv = ["--device", "cpu", "--config",
            os.path.join(ROOT, "configs", "ippo_2player.yaml")] + EVAL_SETS
    from vit_marl_tpu_torch import train as ttrain
    ttrain.main(argv + ["--set", f"CHECKPOINT_DIR={ckpt}",
                        "--set", "LOG_BACKEND=none"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "eval"
    capsys.readouterr()
    res = tevaluate.main(argv + ["--checkpoint-dir", str(ckpt),
                                 "--num-envs", "4", "--num-steps", "3",
                                 "--greedy", "--out-dir", str(out)])
    err = capsys.readouterr()
    assert "restored checkpoint step 0" in err.out
    lines = [x for x in err.err.splitlines() if "matplotlib" in x]
    assert len(lines) == 1 and "heatmap_MM.png" in lines[0]
    assert json.loads((out / "combinations.json").read_text()).keys() == \
        res.keys()
    series = np.load(out / "episodes_LL" / "trajectory.npz")
    assert series["rewards_0"].shape == (3, 2, 1)
    assert not any(p.suffix == ".png" for p in out.rglob("*"))


def test_evaluate_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.main(["--num-envs", "4"] + EVAL_SETS)
