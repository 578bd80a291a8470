"""Learned-vs-Baseline combination rollouts.

Port of ``vit_marl_tpu/eval/combinations.py``: enumerate all 2^n_types
assignments of {Learned, Baseline} per agent type ("BB", "BL", "LB", "LL",
...), roll each out over the batched world, and collect per-type reward
trajectories and episode statistics for the comparison matrix.

The JAX package scans each rollout (``jax.lax.scan``,
``vit_marl_tpu/eval/combinations.py:74``).  :class:`CombinationRollout`
is its counterpart over static buffers (``rl/scan.py::StepGraph``): on a
card one CUDA graph of the step for each policy assignment, replayed
``num_steps`` times, the samples of ``mode="sample"`` drawn from the
generator registered with the graph; on the CPU the same body eagerly.
:func:`rollout_loop` issues every step from the host (``ROLLOUT_MODE=
loop``).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vit_marl_tpu_torch.env.structs import ResetDraws, StepDraws
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.models.rnn import ScannedGRU
from vit_marl_tpu_torch.rl.scan import StepGraph, assign
from vit_marl_tpu_torch.utils.tree import tree_map

Draws = Tuple[ResetDraws, Sequence[StepDraws]]
MODES = ("sample", "greedy")


def _stack(steps: List):
    return tree_map(lambda *v: torch.stack(v), *steps)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'sample' or 'greedy', got {mode!r}")


def _reset(env: WorldEnv, params, num_envs: int, hidden_size: int,
           generator, draws):
    """The reset's observations and state, zero GRU states, no dones."""
    num_actors = [n * num_envs for n in env.n_per_type]
    dev = env.device
    obs, state = env.reset(draws[0] if draws else
                           env.draw_reset(num_envs, generator), params)
    hstates = [ScannedGRU.initialize_carry(a, hidden_size, dev)
               for a in num_actors]
    dones = [torch.zeros(a, dtype=torch.bool, device=dev)
             for a in num_actors]
    return state, obs, dones, hstates


def _policy_actions(env: WorldEnv, policies, obs, hstates, dones,
                    num_envs: int, mode: str, generator):
    """Every type's action on one step: (new GRU states, actions)."""
    hs, actions = list(hstates), []
    for i, pol in enumerate(policies):
        n_actors = env.n_per_type[i] * num_envs
        obs_i = tree_map(lambda v: v.reshape(
            (n_actors,) + tuple(v.shape[2:]))[None], obs[i])
        hs[i], pi, _ = pol(hstates[i], obs_i, dones[i][None])
        a = pi.sample(generator) if mode == "sample" else pi.mode()
        a = a[0].reshape((num_envs, env.n_per_type[i]) + tuple(a.shape[2:]))
        actions.append(a[:, 0] if env.n_per_type[i] == 1 else a)
    return hs, actions


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
    ``generator``.  Runs :class:`CombinationRollout` (on a card a graph
    of the step; with ``draws`` its body eagerly).
    """
    _check_mode(mode)
    return CombinationRollout(env, params, policies, num_envs, num_steps,
                              generator, hidden_size, mode).run(draws)


class CombinationRollout(StepGraph):
    """One policy assignment's rollout over static buffers: the carry
    (env state, observations, done flags, GRU states) and ``(num_steps,
    ...)`` buffers of each step's rewards, actions, ``__all__`` dones and
    infos, an info's fields kept in the step's own buffers
    (``env/structs.py::Info``) and read as views of them, in the tree
    and dtypes :func:`rollout_loop` stacks.  The reset is eager; the
    policies must be capturable (``eval/baselines.py``).  See
    ``rl/scan.py::StepGraph`` for the graph, its generator and stale
    weights."""

    def __init__(self, env: WorldEnv, params, policies: Sequence,
                 num_envs: int, num_steps: int,
                 generator: Optional[torch.Generator] = None,
                 hidden_size: int = 64, mode: str = "sample"):
        _check_mode(mode)
        super().__init__(num_steps, [generator], env.device)
        self.env, self.params = env, params
        self.policies = list(policies)
        self.nets = [p.network for p in self.policies
                     if isinstance(getattr(p, "network", None),
                                   torch.nn.Module)]
        self.num_envs, self.hidden_size = num_envs, hidden_size
        self.mode, self.generator = mode, generator
        self.bufs = None        # the (num_steps, ...) trajectory buffers
        self.layout = None      # the first step's infos: their key order

    def step(self, draws=None) -> None:
        """One step from the carry into slot ``t`` (``draws``: eager runs
        only)."""
        state, obs, dones, hstates = self.carry
        hs, actions = _policy_actions(self.env, self.policies, obs, hstates,
                                      dones, self.num_envs, self.mode,
                                      self.generator)
        obs, state, rewards, done, infos = self.env.step_vec(
            state, actions, self.params, draws=draws,
            generator=self.generator)
        dones = [done["agents"][i].reshape(-1)
                 for i in range(len(self.policies))]
        out = {"rewards": list(rewards), "actions": actions,
               "dones": done["__all__"],
               "agent_infos": [[buf for _, buf in inf.buffers]
                               for inf in infos["agents"]],
               "world_infos": [buf for _, buf in infos["world"].buffers]}
        if self.bufs is None:     # the first (eager) step sizes the slots
            self.bufs = self._slots(out)
            self.layout = ([inf for inf in infos["agents"]], infos["world"])
        self._put(self.bufs, out)
        assign(self.carry, (state, obs, dones, hs))
        self.t.add_(1)

    def _infos(self, info, bufs) -> Dict:
        """An info's fields as ``(num_steps, ...)`` views of the buffers,
        in its key order."""
        where = {k: (b, j) for b, (names, _) in enumerate(info.buffers)
                 for j, k in enumerate(names)}
        return {k: bufs[where[k][0]][:, where[k][1]] for k in info}

    def run(self, draws: Optional[Draws] = None) -> Dict:
        """Reset (eagerly), ``num_steps`` steps; returns the trajectory of
        :func:`rollout` (views of the buffers, valid until the next
        run)."""
        carry = _reset(self.env, self.params, self.num_envs,
                       self.hidden_size, self.generator, draws)
        self.set_carry(carry)
        with torch.no_grad():
            self.replay(draws[1] if draws else None)
        b, (agents, world) = self.bufs, self.layout
        return {"rewards": b["rewards"], "actions": b["actions"],
                "dones": b["dones"],
                "agent_infos": [self._infos(inf, bb) for inf, bb in
                                zip(agents, b["agent_infos"])],
                "world_infos": self._infos(world, b["world_infos"])}


def rollout_loop(env: WorldEnv, params, policies: Sequence, num_envs: int,
                 num_steps: int, generator: Optional[torch.Generator] = None,
                 hidden_size: int = 64, mode: str = "sample",
                 draws: Optional[Draws] = None) -> Dict:
    """:func:`rollout` with every step issued from the host."""
    _check_mode(mode)
    n_types = len(env.agent_types)
    state, obs, dones, hstates = _reset(env, params, num_envs, hidden_size,
                                        generator, draws)
    out = []
    with torch.no_grad():
        for t in range(num_steps):
            hstates, actions = _policy_actions(env, policies, obs, hstates,
                                               dones, num_envs, mode,
                                               generator)
            obs, state, rewards, done, infos = env.step_vec(
                state, actions, params,
                draws=draws[1][t] if draws else None, generator=generator)
            dones = [done["agents"][i].reshape(-1) for i in range(n_types)]
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
                          hidden_size: int = 64,
                          rollout_mode: str = "scan") -> Dict[str, Dict]:
    """All 2^n {L, B} assignments -> label -> rollout summary
    (``mean_rewards`` per type, ``episode_done_frac``, ``traj``).
    ``rollout_mode``: ``scan`` (and ``auto``) replays each label's graph
    (:func:`rollout`); ``loop`` and ``pipeline`` issue every step from
    the host (:func:`rollout_loop`), as the trainer's modes do."""
    n_types = len(env.agent_types)
    run = rollout if rollout_mode in ("scan", "auto") else rollout_loop
    results = {}
    for mask in itertools.product("LB", repeat=n_types):
        label = "".join(mask)
        policies = [learned[i] if m == "L" else baseline[i]
                    for i, m in enumerate(mask)]
        traj = run(env, params, policies, num_envs, num_steps, generator,
                   hidden_size=hidden_size, mode=mode)
        # one read of the summaries, after the label's steps
        values = torch.stack([r.float().mean() for r in traj["rewards"]]
                             + [traj["dones"].float().mean()]).tolist()
        results[label] = {"mean_rewards": values[:-1],
                          "episode_done_frac": values[-1],
                          "traj": traj}
    return results
