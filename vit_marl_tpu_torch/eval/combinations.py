"""Learned-vs-Baseline combination rollouts.

Port of ``vit_marl_tpu/eval/combinations.py``: enumerate all 2^n_types
assignments of {Learned, Baseline} per agent type ("BB", "BL", "LB", "LL",
...), roll each out over the batched world (a loop over ``step_vec``, as
the trainer's rollout), and collect per-type reward trajectories and
episode statistics for the comparison matrix.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vit_marl_tpu_torch.env.structs import ResetDraws, StepDraws
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.models.rnn import ScannedGRU
from vit_marl_tpu_torch.utils.tree import tree_map

Draws = Tuple[ResetDraws, Sequence[StepDraws]]


def _stack(steps: List):
    return tree_map(lambda *v: torch.stack(v), *steps)


def rollout(env: WorldEnv, params, policies: Sequence, num_envs: int,
            num_steps: int, generator: Optional[torch.Generator] = None,
            hidden_size: int = 64, mode: str = "sample",
            draws: Optional[Draws] = None) -> Dict:
    """Roll out one policy assignment; returns stacked rewards, actions,
    dones and infos, ``(num_steps, num_envs, ...)`` each.

    ``mode``: "sample" draws actions from each policy's distribution (the
    reference's eval behaviour); "greedy" takes the distribution mode.
    ``draws``: the reset's and every step's env draws (tests feed the JAX
    package's); without them the env and the samples draw from
    ``generator``.
    """
    if mode not in ("sample", "greedy"):
        raise ValueError(f"mode must be 'sample' or 'greedy', got {mode!r}")
    n_types = len(env.agent_types)
    num_actors = [n * num_envs for n in env.n_per_type]
    dev = env.device
    obs, state = env.reset(draws[0] if draws else
                           env.draw_reset(num_envs, generator), params)
    hstates = [ScannedGRU.initialize_carry(num_actors[i], hidden_size, dev)
               for i in range(n_types)]
    dones = [torch.zeros(num_actors[i], dtype=torch.bool, device=dev)
             for i in range(n_types)]
    out = []
    with torch.no_grad():
        for t in range(num_steps):
            actions = []
            for i, pol in enumerate(policies):
                obs_i = tree_map(lambda v: v.reshape(
                    (num_actors[i],) + tuple(v.shape[2:]))[None], obs[i])
                hstates[i], pi, _ = pol(hstates[i], obs_i, dones[i][None])
                a = pi.sample(generator) if mode == "sample" else pi.mode()
                a = a[0].reshape((num_envs, env.n_per_type[i])
                                 + tuple(a.shape[2:]))
                actions.append(a[:, 0] if env.n_per_type[i] == 1 else a)
            obs, state, rewards, done, infos = env.step_vec(
                state, actions, params,
                draws=draws[1][t] if draws else None, generator=generator)
            dones = [done["agents"][i].reshape(num_actors[i])
                     for i in range(n_types)]
            out.append({
                "rewards": list(rewards),
                "actions": actions,
                "dones": done["__all__"],
                "agent_infos": [dict(inf) for inf in infos["agents"]],
                "world_infos": dict(infos["world"]),
            })
    return _stack(out)


def evaluate_combinations(env: WorldEnv, params, learned: Sequence,
                          baseline: Sequence, num_envs: int, num_steps: int,
                          generator: Optional[torch.Generator] = None,
                          mode: str = "sample",
                          hidden_size: int = 64) -> Dict[str, Dict]:
    """All 2^n {L, B} assignments -> label -> rollout summary
    (``mean_rewards`` per type, ``episode_done_frac``, ``traj``)."""
    n_types = len(env.agent_types)
    results = {}
    for mask in itertools.product("LB", repeat=n_types):
        label = "".join(mask)
        policies = [learned[i] if m == "L" else baseline[i]
                    for i, m in enumerate(mask)]
        traj = rollout(env, params, policies, num_envs, num_steps,
                       generator, hidden_size=hidden_size, mode=mode)
        values = torch.stack([r.float().mean() for r in traj["rewards"]]
                             + [traj["dones"].float().mean()]).tolist()
        results[label] = {"mean_rewards": values[:-1],
                          "episode_done_frac": values[-1],
                          "traj": traj}
    return results
