"""Greedy eval and ``evaluate.py``'s rollouts over static buffers.

On a card ``rl/ppo.py::EvalRollout`` and
``eval/combinations.py::CombinationRollout`` replay one captured CUDA
graph of their step; on the CPU the same body runs eagerly, so these
tests hold the captured function against the host-issued loops on the
same generator states, bit for bit:

- ``EvalRollout.run`` against ``eval_rollout_loop`` (every metric, with
  and without ``log_env_info``), on the 2-player world and the vision
  world (a micro ViT), twice from one object (the buffers reused);
- ``CombinationRollout`` against ``rollout_loop`` in ``sample`` and
  ``greedy`` modes, with learned, fixed, random and fixed ``Box``
  policies: every leaf of the trajectory tree, its dtype and shape;
- ``make_train`` with ``EVAL_EVERY=1`` under ``scan`` (the eval body)
  and ``loop`` (the eval loop): bit-equal metrics over two updates;
- ``evaluate_combinations`` under ``ROLLOUT_MODE`` ``scan`` and ``loop``.

The JAX comparisons of both rollouts go through the bodies too
(``tests/test_torch_eval.py``: ``eval_rollout`` and
``combinations.rollout`` run them).  The graphs themselves:
``tests/test_torch_kernel_gpu.py``.
"""

import numpy as np
import pytest
import torch

from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.eval import baselines as tbase
from vit_marl_tpu_torch.eval import combinations as tcomb
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils.tree import tree_leaves

WORLD = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)
VISION_EXEC = dict(action_space="policy_blending",
                   observation_space="execution_policy",
                   reward_space="dual_ppo", use_vision_obs=True,
                   task_size=500)
E, T = 4, 5


def _world(kind):
    exe = {"vision": tcfg.ExecutionConfig(**VISION_EXEC),
           "box": tcfg.ExecutionConfig(action_space="fixed_prices",
                                       n_actions=4)}.get(
        kind, tcfg.ExecutionConfig())
    return WorldEnv(tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**WORLD),
        agents=(tcfg.MarketMakingConfig(), exe)), device="cpu")


def _nets(env, kind):
    tc = tcfg.TrainConfig(vit_preset="micro", network=(
        ("gru", "vit_gru") if kind == "vision" else ("gru", "gru")))
    torch.manual_seed(0)
    return tppo.make_networks(env, tc), tc.hidden_size


def _gens(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator()
    b.set_state(a.get_state())
    return a, b


def _assert_equal(got, want, label):
    la, lb = tree_leaves(got), tree_leaves(want)
    assert len(la) == len(lb) > 0, label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape \
            and torch.equal(x, y), f"{label}: leaf {i}"


@pytest.mark.parametrize("kind", ["two_player", "vision"])
def test_eval_body_is_the_loop(kind):
    env = _world(kind)
    nets, hidden = _nets(env, kind)
    for info in (True, False):
        gen, twin = _gens(1)
        body = tppo.EvalRollout(env, nets, E, T, hidden, info, gen)
        for rnd in range(2):
            got = body.run()
            want = tppo.eval_rollout_loop(env, nets, E, T, hidden, info,
                                          twin)
            assert list(got) == list(want)
            for k in want:
                assert torch.equal(got[k], want[k]), f"{rnd} {info} {k}"
            assert torch.equal(gen.get_state(), twin.get_state())
        assert body.captures == 0 and not body.use_graph
        assert ("eval_MM/action_pct_0" in got) is info
        assert any(k.startswith("eval_world/") for k in got) is info


def _policies(env, kind, nets):
    if kind == "box":
        sp = env.action_spaces[1]
        low = sp.low.cpu().numpy() if hasattr(sp.low, "cpu") else sp.low
        # a read-only array, as evaluate.py's np.broadcast_to gives
        return [tbase.LearnedPolicy(nets[0]),
                tbase.FixedActionPolicy(np.broadcast_to(
                    np.asarray(low, np.float32), sp.shape),
                    continuous=True)]
    n = [sp.n for sp in env.action_spaces]
    return [tbase.RandomPolicy(n[0]), tbase.LearnedPolicy(nets[1]),
            tbase.FixedActionPolicy(0, n_actions=n[1])][:2] \
        if kind == "random" else [tbase.LearnedPolicy(nets[0]),
                                  tbase.FixedActionPolicy(1, n[1])]


@pytest.mark.parametrize("mode", ["sample", "greedy"])
@pytest.mark.parametrize("kind", ["two_player", "random", "box"])
def test_combination_body_is_the_loop(kind, mode):
    env = _world("box" if kind == "box" else "two_player")
    nets, hidden = _nets(env, kind)
    pols = _policies(env, kind, nets)
    gen, twin = _gens(2)
    body = tcomb.CombinationRollout(env, env.default_params, pols, E, T,
                                    gen, hidden, mode)
    for rnd in range(2):
        got = body.run()
        want = tcomb.rollout_loop(env, env.default_params, pols, E, T, twin,
                                  hidden_size=hidden, mode=mode)
        assert list(got) == list(want)
        assert list(got["agent_infos"][0]) == list(want["agent_infos"][0])
        assert list(got["world_infos"]) == list(want["world_infos"])
        _assert_equal(got, want, f"{kind} {mode} run {rnd}")
        assert tuple(got["rewards"][0].shape)[:2] == (T, E)
    assert torch.equal(gen.get_state(), twin.get_state())
    assert bool(got["dones"].any())


def test_make_train_eval_under_scan_is_loop():
    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD))
    runs = {}
    for mode in ("scan", "loop"):
        tc = tcfg.TrainConfig(num_envs=4, num_steps=4, num_minibatches=2,
                              update_epochs=1, total_timesteps=32,
                              rollout_mode=mode, log_backend="none",
                              eval_every=1, eval_steps=3, eval_envs=4)
        out = tppo.make_train(ma, tc, device="cpu")(seed=3)
        runs[mode] = [{k: v for k, v in m.items()
                       if k not in ("rollout_s", "update_s")}
                      for m in out["metrics"]]
    assert [m["update_step"] for m in runs["scan"]] == [0, 1]
    assert "MM/eval_mean_reward" in runs["scan"][1]
    assert runs["scan"] == runs["loop"]


def test_evaluate_combinations_under_both_modes():
    env = _world("two_player")
    nets, hidden = _nets(env, "two_player")
    n = [sp.n for sp in env.action_spaces]
    learned = [tbase.LearnedPolicy(nets[0]), tbase.RandomPolicy(n[1])]
    baseline = [tbase.FixedActionPolicy(3, n[0]),
                tbase.FixedActionPolicy(0, n[1])]
    res = {mode: tcomb.evaluate_combinations(
        env, env.default_params, learned, baseline, E, 3,
        torch.Generator().manual_seed(0), hidden_size=hidden,
        rollout_mode=mode) for mode in ("scan", "loop")}
    assert list(res["scan"]) == ["LL", "LB", "BL", "BB"]
    for label, r in res["scan"].items():
        assert r["mean_rewards"] == res["loop"][label]["mean_rewards"]
        _assert_equal(r["traj"], res["loop"][label]["traj"], label)
