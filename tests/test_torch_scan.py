"""``ROLLOUT_MODE=scan``: the rollout over static buffers (``rl/scan.py``).

On a card the body of :class:`ScanRollout` is captured as a CUDA graph and
replayed; on the CPU the same body runs eagerly, so these tests hold the
captured function:

- ``ScanRollout.step`` run ``T`` times gives trajectories, per-step info
  moments and the final carry bit-equal to ``rl/ppo.py::rollout_loop``
  from the same carry and generator state: the 2-player world, the
  vision world (a micro ViT), ``debug_mode``, a ``Box`` action on
  ``gru``, and each rank of a 2-rank gloo group over the sharded step;
  a second run from the returned carry continues both; ``run(carry,
  steps=k)`` is the loop's first ``k`` steps;
- ``make_train`` under ``scan`` and ``loop`` gives bit-equal metrics over
  2 updates and a resume (the port's counterpart of
  ``tests/test_ppo.py:153-154``);
- the mode resolves as in the JAX package: ``auto`` is the scan, which
  takes the graph on a CUDA device (``loop`` and ``pipeline`` name
  themselves); an unknown mode raises.

The graph itself, one replay of the 2-player step against the loop, is
in ``tests/test_torch_kernel_gpu.py``; the bench's ``--mode scan`` on the
CPU in ``tests/test_torch_bench.py``.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.parallel.distributed import run_group
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.rl.scan import ScanRollout, assign
from vit_marl_tpu_torch.utils.tree import tree_leaves

WORLD = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)
VISION_EXEC = dict(action_space="policy_blending",
                   observation_space="execution_policy",
                   reward_space="dual_ppo", use_vision_obs=True,
                   task_size=500)


def _world(kind):
    world = tcfg.WorldConfig(**WORLD, debug_mode=kind == "debug")
    exe = {"vision": tcfg.ExecutionConfig(**VISION_EXEC),
           "box": tcfg.ExecutionConfig(action_space="fixed_prices",
                                       n_actions=4)}.get(
        kind, tcfg.ExecutionConfig())
    return tcfg.MultiAgentConfig(world=world,
                                 agents=(tcfg.MarketMakingConfig(), exe))


def _network(kind):
    return ("gru", "vit_gru") if kind == "vision" else ("gru", "gru")


def _assert_equal_trees(a, b, label):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), \
            f"{label}: leaf {i} differs"


def _twin(g):
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


@pytest.mark.parametrize("kind", ["two_player", "vision", "debug", "box"])
def test_scan_body_is_the_loop(kind):
    E, T = 4, 5
    env = WorldEnv(_world(kind), device="cpu")
    tc = tcfg.TrainConfig(num_envs=E, num_steps=T, vit_preset="micro",
                          network=_network(kind))
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
    twin = _twin(gen)
    scan = ScanRollout(env.step_vec, nets, params, T, E, env.n_per_type,
                       gen, gen, True, "cpu")
    with torch.no_grad():
        for rnd in range(2):
            got = scan.run(carry)
            want = tppo.rollout_loop(env.step_vec, nets, carry, params, T, E,
                                     env.n_per_type, twin, twin, True)
            for i in range(len(nets)):
                _assert_equal_trees(got[0][i], want[0][i],
                                    f"run {rnd}, type {i} trajectory")
            _assert_equal_trees(got[1], want[1], f"run {rnd}, info moments")
            _assert_equal_trees(got[2], want[2], f"run {rnd}, final carry")
            # the next run starts from the scan's carry (its buffers) and
            # the loop's from the loop's: equal, as checked above
            carry = want[2]
            assert torch.equal(scan.t, torch.tensor([T]))
    assert bool(torch.cat([t.global_done.flatten()
                           for t in got[0]]).any())
    if kind == "debug":
        assert got[2].state.world.trades is not None


def test_scan_runs_its_first_steps():
    """``run(carry, steps=k)`` runs the first ``k`` of the buffers' ``T``
    steps: slots ``:k`` and the carry are the loop's over ``k`` steps; more
    than ``T`` steps raise."""
    E, T, k = 4, 5, 2
    env = WorldEnv(_world("two_player"), device="cpu")
    tc = tcfg.TrainConfig(num_envs=E, num_steps=T)
    torch.manual_seed(0)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator().manual_seed(2)
    params = env.default_params
    obs, state = env.reset(env.draw_reset(E, gen), params)
    actors = [n * E for n in env.n_per_type]
    carry = tppo.Carry(state, obs, [torch.zeros(a, dtype=torch.bool)
                                    for a in actors],
                       [torch.zeros(a, tc.hidden_size) for a in actors])
    twin = _twin(gen)
    scan = ScanRollout(env.step_vec, nets, params, T, E, env.n_per_type,
                       gen, gen, True, "cpu")
    with torch.no_grad():
        want = tppo.rollout_loop(env.step_vec, nets, carry, params, k, E,
                                 env.n_per_type, twin, twin, True)
        got = scan.run(carry, steps=k)
    for i in range(len(nets)):
        _assert_equal_trees([x[:k] for x in tree_leaves(got[0][i])],
                            tree_leaves(want[0][i]), f"type {i}")
    _assert_equal_trees([x[:k] for x in tree_leaves(got[1])],
                        tree_leaves(want[1]), "info moments")
    _assert_equal_trees(got[2], want[2], "final carry")
    assert torch.equal(scan.t, torch.tensor([k])) and scan.replays == 0
    with pytest.raises(ValueError, match="buffers hold 5"):
        scan.run(carry, steps=T + 1)


def test_scan_under_a_two_rank_group():
    ma = _world("two_player")
    tc = tcfg.TrainConfig(num_envs=4, num_steps=3, log_backend="none",
                          mesh_shape=(2,), mesh_axes=("data",))
    outs = run_group(workers.scan_against_loop, 2, (ma, tc, 5),
                     deadline_s=120.0)
    assert [o[2] for o in outs] == [0, 1]
    for bad, n_leaves, rank in outs:
        assert n_leaves > 10 and bad == [], f"rank {rank}: leaves {bad}"


def _train_cfg(mode, **kw):
    return tcfg.TrainConfig(num_envs=4, num_steps=4, num_minibatches=2,
                            update_epochs=1, total_timesteps=48,
                            rollout_mode=mode, log_backend="none", **kw)


def _metrics(out):
    return [{k: v for k, v in m.items() if k not in ("rollout_s",
                                                       "update_s")}
            for m in out["metrics"]]


def test_make_train_scan_is_loop_over_updates_and_a_resume(tmp_path):
    ma = _world("two_player")
    runs = {}
    for mode in ("scan", "loop"):
        ck = str(tmp_path / mode)
        a = tppo.make_train(ma, _train_cfg(mode, checkpoint_dir=ck),
                            device="cpu")(seed=3, n_updates=2)
        b = tppo.make_train(ma, _train_cfg(mode, checkpoint_dir=ck,
                                           resume=True),
                            device="cpu")(seed=3)
        runs[mode] = (_metrics(a), _metrics(b), a["networks"],
                      b["networks"])
    (sa, sb, sn, sr), (la, lb, ln, lr) = runs["scan"], runs["loop"]
    assert [m["update_step"] for m in sa] == [0, 1]
    assert [m["update_step"] for m in sb] == [2]
    assert sa == la and sb == lb
    assert all(np.isfinite(v) for m in sa + sb for v in m.values())
    for x, y in zip(sn + sr, ln + lr):
        for k, v in x.state_dict().items():
            assert torch.equal(v, y.state_dict()[k]), k


def test_rollout_mode_resolves_as_the_jax_package():
    assert tppo.rollout_mode("auto") == "scan"
    for mode in ("scan", "loop", "pipeline"):
        assert tppo.rollout_mode(mode) == mode
    # the scan replays a graph on a card and runs its body on the CPU
    for dev, graph in (("cuda", True), ("cpu", False)):
        assert ScanRollout(None, [], None, 1, 1, (1,), None, None, False,
                           dev).use_graph is graph
    with pytest.raises(ValueError, match="ROLLOUT_MODE"):
        tppo.rollout_mode("fast")
    with pytest.raises(ValueError, match="ROLLOUT_MODE"):
        tppo.make_train(_world("two_player"), _train_cfg("fast"),
                        device="cpu")


def test_assign_clones_leaves_that_alias_other_buffers():
    """A new carry may hand an unchanged field on, or the buffer of
    another field: each buffer still receives its own leaf's value."""
    a, b, c = torch.arange(3.0), torch.arange(3.0) + 10, torch.zeros(3)
    assign([a, b, c], [b, a, c])
    assert a.tolist() == [10.0, 11.0, 12.0] and b.tolist() == [0.0, 1.0, 2.0]
    assert c.tolist() == [0.0] * 3
