"""The batched env step over this rank's share of the envs.

Counterpart of ``vit_marl_tpu/parallel/shard_step.py``.  The JAX package
needs a ``shard_map`` there because GSPMD would replicate its Pallas book
kernel; in the port each rank holds only its own envs, so the sharded
step is ``WorldEnv.step_vec`` on the local batch, and on the card each
rank's step runs the book-scan kernel (kernel 1) on its shard.  Draws of
the whole batch (``StepDraws``, as the tests replay them from the JAX
package's keys) are sliced to the rank's envs; in production each rank
draws its own from its generator, seeded from (seed, rank)
(:func:`rank_seed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vit_marl_tpu_torch.env.structs import ResetDraws, StepDraws


def rank_seed(seed: int, rank: int) -> int:
    """A rank's generator seed: ``seed`` itself on rank 0 (a group of one
    rank draws as one process does), else one derived from (seed, rank)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), rank])
               .generate_state(1, np.uint64)[0] >> 1)


def local_step_draws(draws: StepDraws, lo: int, hi: int) -> StepDraws:
    """Envs ``lo:hi`` of a step's draws (the cancel uniforms are ``(M,
    E)``: their env axis is the second)."""
    return StepDraws(
        shuffle=None if draws.shuffle is None else draws.shuffle[lo:hi],
        uniforms=None if draws.uniforms is None
        else draws.uniforms[:, lo:hi],
        reset=local_reset_draws(draws.reset, lo, hi),
        agents=tuple(None if d is None else dataclasses.replace(
            d, **{f.name: None if getattr(d, f.name) is None
                  else getattr(d, f.name)[lo:hi]
                  for f in dataclasses.fields(d)})
            for d in draws.agents))


def local_reset_draws(draws: ResetDraws, lo: int, hi: int) -> ResetDraws:
    return ResetDraws(window=draws.window[lo:hi],
                      agents=tuple(None if d is None else d[lo:hi]
                                   for d in draws.agents))


def make_sharded_step(env, group):
    """``step(state, actions, params, draws=None, generator=None)``: the
    step of this rank's envs.  ``state`` and ``actions`` are the rank's;
    ``draws`` may be the whole batch's (sliced here) or the rank's own;
    without them the step draws from ``generator``."""

    def step(state, actions, params, draws=None, generator=None):
        n = state.world.step_counter.shape[0]
        if draws is not None and draws.reset.window.shape[0] != n:
            lo = group.rank * n
            draws = local_step_draws(draws, lo, lo + n)
        return env.step_vec(state, actions, params, draws=draws,
                            generator=generator)

    return step
