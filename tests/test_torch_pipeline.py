"""The split-batch pipelined rollout (``rl/pipeline.py``) against the
JAX package's schedule and against the loop rollout.

- The runner calls the two half functions in the order of
  ``vit_marl_tpu/rl/pipeline.py::make_pipelined_runner`` (prologue
  ``P_A(0)``, ticks ``[E_x | P_y]``, epilogue ``E_B(T-1)``), with each
  half's state threaded through, ``merged`` or not;
- the trainer's pipelined collect (``rl/ppo.py::rollout_pipeline``, on
  the CPU: the schedule in order) is bit-equal to two loop rollouts
  (``rollout_loop``), one a half, on the same generators' draws:
  trajectories, info moments and the final carry;
- ``make_train`` with ``ROLLOUT_MODE=pipeline`` trains (finite metrics)
  and refuses an odd ``NUM_ENVS``, as the JAX package does;
- the bench's ``--mode pipeline`` and ``pipeline-seq`` give the JAX
  bench's labels and bit-equal observations and actions.
"""

import io
import contextlib

import jax
import numpy as np
import pytest
import torch

from vit_marl_tpu.rl import pipeline as jpipe
from vit_marl_tpu_torch import bench
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.rl.pipeline import make_pipelined_runner, split_half
from vit_marl_tpu_torch.utils.tree import tree_leaves, tree_map

WORLD = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)


def _recording_halves(log, scalar):
    """Half functions that log (kind, half, step) and thread counters."""
    def policy_half(params, pol_state, pol_in):
        h, t = pol_state
        log.append(("P", h, t))
        return (h, t + 1), scalar(10 * h + t), (h, t)

    def env_half(params, env_state, acts):
        h, t = env_state
        log.append(("E", h, t, int(acts)))
        return (h, t + 1), scalar(t), (h, t)
    return policy_half, env_half


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("merged", [False, True])
def test_schedule_matches_jax(n_steps, merged):
    jlog, tlog = [], []
    jp, je = _recording_halves(jlog, lambda v: jax.numpy.asarray(v))
    with jax.disable_jit():
        jout = jpipe.make_pipelined_runner(jp, je, merged=merged)(
            None, [(0, 0), (1, 0)], [(0, 0), (1, 0)], [0, 0], n_steps)
    tp, te = _recording_halves(tlog, lambda v: torch.tensor(v))
    tout = make_pipelined_runner(tp, te, merged=merged)(
        None, [(0, 0), (1, 0)], [(0, 0), (1, 0)],
        [torch.tensor(0), torch.tensor(0)], n_steps)
    assert tlog == jlog
    assert len(tlog) == 4 * n_steps
    # final states, and per-half outputs of every step
    assert tout[0] == [tuple(int(x) for x in s) for s in jout[0]]
    assert tout[1] == [tuple(int(x) for x in s) for s in jout[1]]
    for h in (0, 1):
        assert tout[3][h] == [tuple(int(x) for x in p) for p in jout[3][h]]
        assert tout[4][h] == [tuple(int(x) for x in e) for e in jout[4][h]]


def _clone(g):
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


def _world(vision=False):
    exe = (tcfg.ExecutionConfig(action_space="policy_blending",
                                observation_space="execution_policy",
                                reward_space="dual_ppo", use_vision_obs=True,
                                task_size=500)
           if vision else tcfg.ExecutionConfig())
    return tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD),
                                 agents=(tcfg.MarketMakingConfig(), exe))


def _assert_equal_trees(a, b, label):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{label}: leaf {i} differs"


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("vision", [False, True], ids=["gru", "vit_gru"])
def test_pipelined_collect_is_two_loop_rollouts(vision, merged):
    E, T = 6, 5
    ma = _world(vision)
    env = WorldEnv(ma, device="cpu")
    tc = tcfg.TrainConfig(num_envs=E, num_steps=T, vit_preset="micro",
                          network=("gru", "vit_gru") if vision
                          else ("gru", "gru"))
    torch.manual_seed(0)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator().manual_seed(1)
    params = env.default_params
    obs, state = env.reset(env.draw_reset(E, gen), params)
    actors = [n * E for n in env.n_per_type]
    # a carry mid-episode: non-zero GRU states and some dones
    hs = [torch.randn(a, tc.hidden_size, generator=gen) for a in actors]
    dones = [torch.rand(a, generator=gen) < 0.3 for a in actors]
    carry = tppo.Carry(state, obs, dones, hs)
    gens = tppo.pipeline_generators(7, "cpu")
    copies = [[_clone(g) for g in row] for row in gens]
    with torch.no_grad():
        trajs, info, new = tppo.rollout_pipeline(
            env.step_vec, nets, carry, params, T, E, env.n_per_type, gens,
            True, merged=merged)
        half, parts = E // 2, []
        for h in (0, 1):
            a_h = [n * half for n in env.n_per_type]
            c_h = tppo.Carry(split_half(state, h, half),
                             [split_half(o, h, half) for o in obs],
                             [split_half(d, h, a) for d, a in zip(dones, a_h)],
                             [split_half(x, h, a) for x, a in zip(hs, a_h)])
            parts.append(tppo.rollout_loop(
                env.step_vec, nets, c_h, params, T, half, env.n_per_type,
                copies[0][h], copies[1][h], True))
    for i in range(len(nets)):
        want = tree_map(lambda a, b: torch.cat([a, b], dim=1),
                        parts[0][0][i], parts[1][0][i])
        _assert_equal_trees(trajs[i], want, f"type {i} trajectory")
    _assert_equal_trees(info, tree_map(lambda a, b: (a + b) / 2,
                                       parts[0][1], parts[1][1]), "info")
    want = tppo.Carry(*[tree_map(lambda a, b: torch.cat([a, b]), x, y)
                        for x, y in zip(parts[0][2], parts[1][2])])
    _assert_equal_trees(new, want, "final carry")
    # the episode boundary was crossed inside the rollout
    assert bool(torch.cat([t.global_done.flatten() for t in trajs]).any())


def test_make_train_pipeline_trains_and_refuses_odd_envs():
    ma = _world()
    tc = tcfg.TrainConfig(num_envs=4, num_steps=4, update_epochs=1,
                          num_minibatches=2, total_timesteps=32,
                          rollout_mode="pipeline", log_backend="none")
    out = tppo.make_train(ma, tc, device="cpu")(seed=0, n_updates=1)
    m = out["metrics"][0]
    assert all(np.isfinite(v) for v in m.values())
    assert any("/info_" in k for k in m)
    with pytest.raises(ValueError, match="even NUM_ENVS"):
        tppo.make_train(ma, tcfg.TrainConfig(num_envs=3,
                                             rollout_mode="pipeline"),
                        device="cpu")


def test_bench_pipeline_modes(monkeypatch):
    """The labels of the JAX bench, and the two modes' observations and
    actions bit-equal (on the CPU both issue the schedule in order; the
    card's two streams are checked in chip_smoke.py phase 17); on a
    3,000-message day."""
    from test_torch_bench import _small_day
    monkeypatch.setattr(bench, "_day_data", _small_day)
    finals = {}
    for mode in ("pipeline", "pipeline-seq"):
        argv = ["--smoke", "--device", "cpu", "--policy", "gru", "--mode",
                mode]
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            out = bench.main(argv)
        assert out["metric"] == f"env_steps_per_sec_per_chip[gru,{mode}]"
        assert out["value"] > 0 and buf.getvalue().count("\n") == 1
        finals[mode] = bench.measure(bench.parse_args(argv),
                                     torch.device("cpu"))["final"]
    _assert_equal_trees(finals["pipeline"], finals["pipeline-seq"],
                        "pipeline against pipeline-seq")
    with pytest.raises(ValueError, match="policy"):
        bench.measure(bench.parse_args(["--smoke", "--policy", "none",
                                        "--mode", "pipeline"]),
                      torch.device("cpu"))
