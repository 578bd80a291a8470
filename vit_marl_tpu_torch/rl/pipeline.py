"""Split-batch software-pipelined rollout on two CUDA streams.

Port of ``vit_marl_tpu/rl/pipeline.py``.  The env batch is split into
two halves at env boundaries.  The data dependency (policy(obs_t) -> env
step t -> obs_t+1) lies within a half; across halves the work is
independent.  So the env step of one half and the policy forward of the
other may run at once, in the same schedule as the JAX package's::

    prologue:  P_A(0)
    ticks:     [E_A(0) | P_B(0)], [E_B(0) | P_A(1)], [E_A(1) | P_B(1)],
               ...,               [E_A(T-1) | P_B(T-1)]
    epilogue:  E_B(T-1)

The JAX package packs each tick's two halves into one XLA program; here
``merged=True`` issues a tick's env half on one CUDA stream and its
policy half on another.  The env stream waits for the event recorded
after the policy half that made its actions; the policy stream waits for
the event recorded after the env half that made its observations; those
are the only waits.  Tensors made on one stream and read on the other
are marked with ``record_stream`` so the caching allocator keeps them
until the reader is done.  At the end the caller's stream waits for
both.  ``merged=False`` issues the same schedule on the caller's stream:
the bit-equality reference and the A/B arm.  On the CPU both run the
schedule in order.

Each half's randomness rides in its states (a ``torch.Generator`` each
for its policy and its env), so both ways draw the same numbers.  The
host issues every kernel of both streams from one thread: the halves
overlap on the card only as far as the host runs ahead of it.

Numerics: per-env math is unchanged; the draws of a half-batch are
another, identically distributed realisation than the whole batch's (a
documented divergence, as in the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from vit_marl_tpu_torch.utils.tree import tree_leaves, tree_map


def split_half(tree, idx: int, half: int):
    """Rows ``[idx*half:(idx+1)*half]`` of every leaf's leading axis."""
    return tree_map(lambda v: v[idx * half:(idx + 1) * half], tree)


def concat_halves(a, b):
    """Two half-batch trees joined along the leading axis."""
    return tree_map(lambda x, y: torch.cat([x, y], dim=0), a, b)


def _hand_over(tree, stream) -> None:
    """Mark every tensor of ``tree`` as used on ``stream``."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


def make_pipelined_runner(policy_half: Callable, env_half: Callable,
                          merged: bool = True) -> Callable:
    """Build the pipelined rollout runner.

    ``policy_half(params, pol_state, pol_in) -> (pol_state', actions,
    pol_out)`` and ``env_half(params, env_state, actions) -> (env_state',
    pol_in', env_out)`` are half-batch functions; their generators ride
    in the states.

    Returns ``run(params, pol_states, env_states, pol_ins, n_steps)``
    with ``pol_states``, ``env_states``, ``pol_ins`` as [half0, half1]
    lists; it returns ``(pol_states, env_states, pol_ins, pol_outs,
    env_outs)``, where ``pol_outs[h]`` / ``env_outs[h]`` are per-step
    lists (length ``n_steps``) for half ``h``.  ``merged`` takes effect
    where the inputs lie on a CUDA device.
    """

    def run(params, pol_states: List[Any], env_states: List[Any],
            pol_ins: List[Any], n_steps: int) -> Tuple:
        pol_states, env_states, pol_ins = (list(pol_states),
                                           list(env_states), list(pol_ins))
        leaves = [t for t in tree_leaves(pol_ins)
                  if isinstance(t, torch.Tensor)]
        dev = leaves[0].device if leaves else torch.device("cpu")
        streams = merged and dev.type == "cuda"
        acts: List[Any] = [None, None]
        pol_outs: List[List[Any]] = [[], []]
        env_outs: List[List[Any]] = [[], []]
        if streams:
            caller = torch.cuda.current_stream(dev)
            env_s, pol_s = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
            env_s.wait_stream(caller)
            pol_s.wait_stream(caller)
            _hand_over((pol_states, env_states, pol_ins), env_s)
            _hand_over((pol_states, env_states, pol_ins), pol_s)
            acted = [None, None]       # events: half h's actions made
            stepped = [None, None]     # events: half h's obs made

        def policy(h):
            if not streams:
                pol_states[h], acts[h], p = policy_half(
                    params, pol_states[h], pol_ins[h])
                pol_outs[h].append(p)
                return
            if stepped[h] is not None:
                pol_s.wait_event(stepped[h])
            with torch.cuda.stream(pol_s):
                pol_states[h], acts[h], p = policy_half(
                    params, pol_states[h], pol_ins[h])
                acted[h] = torch.cuda.Event()
                acted[h].record(pol_s)
            _hand_over(acts[h], env_s)
            pol_outs[h].append(p)

        def env(h):
            if not streams:
                env_states[h], pol_ins[h], e = env_half(
                    params, env_states[h], acts[h])
                env_outs[h].append(e)
                return
            env_s.wait_event(acted[h])
            with torch.cuda.stream(env_s):
                env_states[h], pol_ins[h], e = env_half(
                    params, env_states[h], acts[h])
                stepped[h] = torch.cuda.Event()
                stepped[h].record(env_s)
            _hand_over(pol_ins[h], pol_s)
            env_outs[h].append(e)

        # prologue: the policy of half 0
        policy(0)
        x, y = 0, 1
        for _ in range(2 * n_steps - 1):
            env(x)             # [E_x | P_y]: issued in this order, as the
            policy(y)          # JAX tick returns (env_half, policy_half)
            x, y = y, x
        # epilogue: the pending env half
        env(x)
        if streams:
            caller.wait_stream(env_s)
            caller.wait_stream(pol_s)
        return pol_states, env_states, pol_ins, pol_outs, env_outs

    return run
