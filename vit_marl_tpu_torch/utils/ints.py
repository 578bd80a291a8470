"""Integer allocation utilities, batched over leading axes.

Port of ``vit_marl_tpu/utils/ints.py``: execution agents split a share
quantity across orders without rounding drift (Hamilton apportionment) and
cap action quantities at the remaining task (proportional integer clip).
Every function takes ``(..., k)`` vectors and works on the last axis.

The apportionment's random tie-break enters as an argument: one uniform
draw in ``[0, 1)`` per pick, which selects among the tied maxima exactly
as ``jax.random.choice(key, k, p=is_max / is_max.sum())`` turns its own
uniform into an index (``p_cuml[-1] * (1 - u)`` searched in the cumulative
``p``).  A uniform ``u`` gives every tied maximum the same chance, so the
distribution of each pick is the JAX package's.
"""

from __future__ import annotations

import torch

from vit_marl_tpu_torch.utils.device import const

Tensor = torch.Tensor


def argsort_rev(arr: Tensor) -> Tensor:
    """Descending argsort with left-to-right tie priority
    (ref: utils.py:11-13)."""
    k = arr.shape[-1]
    return (k - 1 - torch.argsort(arr.flip(-1), dim=-1, stable=True)
            ).flip(-1)


def rank_rev(arr: Tensor) -> Tensor:
    """Descending rank, ties resolved left-to-right (ref: utils.py:15-17)."""
    return torch.argsort(argsort_rev(arr), dim=-1)


def clip_by_sum_int(a: Tensor, max_sum: Tensor) -> Tensor:
    """Clip integer vectors so each sums to at most ``max_sum``, keeping
    proportions, ties resolved left-to-right (ref: utils.py:20-52);
    ``a`` is ``(..., k)``, ``max_sum`` ``(...)``."""
    max_sum = const(max_sum, a.dtype, a.device)
    max_sum = max_sum.expand(a.shape[:-1])[..., None]
    a_sum = a.sum(dim=-1, keepdim=True, dtype=a.dtype)
    over = a_sum > max_sum
    # vectors at or under the cap keep ``a``; 1 stands in as their divisor
    num = a * max_sum
    den = torch.where(over, a_sum, torch.ones_like(a_sum))
    q = torch.div(num, den, rounding_mode="floor")
    rem = num - q * den
    rest = max_sum - q.sum(dim=-1, keepdim=True, dtype=a.dtype)
    clipped = torch.where(rank_rev(rem) < rest, q + 1, q)
    return torch.where(over, clipped, a)


def _float_divmod(x: Tensor, y: Tensor):
    """``jnp.divmod`` of floats (CPython's float_divmod, as the JAX
    package's ``_float_divmod``)."""
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    mod = torch.where(fix, mod + y, mod)
    div = torch.where(fix, div - 1, div)
    return torch.round(div), mod


def hamilton_apportionment_permuted(votes: Tensor, seats: Tensor,
                                    uniforms: Tensor) -> Tensor:
    """Randomized largest-remainder apportionment (ref: utils.py:79-114).

    Allocates ``seats`` (``(...)``) integer units in proportion to
    ``votes`` (``(..., k)``); the units left after the floors go, one a
    pick, to a maximal remainder chosen by that pick's uniform in
    ``uniforms`` (``(..., k)``, pick ``j`` reads ``uniforms[..., j]``).
    Returns float32 seats, as the reference does.
    """
    votes = votes.to(torch.float32)
    seats = const(seats, None, votes.device).expand(
        votes.shape[:-1])
    std_divisor = votes.sum(dim=-1) / seats.to(torch.float32)
    init_seats, rem = _float_divmod(votes, std_divisor[..., None])
    remaining = (seats.to(torch.float32) - init_seats.sum(dim=-1)).to(
        torch.int32)
    k = votes.shape[-1]
    for x in range(k):
        is_max = rem == rem.amax(dim=-1, keepdim=True)
        dist = is_max.to(torch.float32) / is_max.sum(
            dim=-1, keepdim=True).to(torch.float32)
        p_cuml = dist.cumsum(dim=-1)
        r = p_cuml[..., -1:] * (1 - uniforms[..., x:x + 1])
        chosen = torch.searchsorted(p_cuml.contiguous(), r.contiguous())
        chosen = chosen.clamp(max=k - 1)
        onehot = torch.arange(k, device=votes.device) == chosen
        add = (x < remaining).to(torch.float32)[..., None]
        init_seats = init_seats + torch.where(onehot, add, 0.0)
        rem = torch.where(onehot, 0.0, rem)
    return init_seats
