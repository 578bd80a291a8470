"""The book scan at every book capacity, the upstream's 100 orders a side
among them, against the JAX package.

The Pallas kernel takes ``n_orders % 8 == 0``; at other capacities the JAX
world runs its XLA scan.  Here the port's plain versions of kernels 1 and
2 (aggregate and records mode) meet

- the Pallas kernels in interpret mode at S=24, a capacity that takes the
  CUDA kernel's masked route;
- the vmapped XLA engine at S=2 and S=100 on the corners both JAX engines
  share with fresh order ids (``make_corner_case(..., shared=True,
  fresh_ids=True)``), its log against the records of every fill;

and the port's ``step_vec`` at ``n_orders=100`` meets the JAX ``step_vec``
(its XLA scan) for 3 steps on replayed draws, in the default world and in
``debug_mode`` with random cancels (``rec_k = n_orders``: the whole log).
Also: ``capacity_route``, the CUDA kernel's slot map, for every capacity
(past 1,024 the block route; ``tests/test_torch_deep_book.py`` holds the
plain versions past it against the JAX package).

Tolerances: every book, best quote, sum, record and trade log bit-equal;
float observations, rewards and state within atol/rtol 1e-5 (float32), as
in ``tests/test_torch_env.py``.
"""

import pytest
import torch

from test_torch_book_kernel import check_pallas_interpret, check_xla_engine
from test_torch_book_records import check_records_pallas, check_records_xla
from test_torch_env import WORLD, _run_steps
from torch_cases import add_sweeps, make_case, make_corner_case
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.ops import book_kernel as bkern

UPSTREAM = 100      # orders a side of the upstream stack's book


def test_capacity_route_covers_every_capacity():
    """Every S from 1 to 1,024 has a warp's slot map that holds it: the
    smallest power of two of slots a lane, masked but at 32, 64, 128 and
    256; every S from 1,025 to 65,536 the block route (a block of threads
    an env, nothing masked), also where a CUDA launch checks its inputs;
    only S < 1 raises."""
    for S in range(1, bkern.WARP_CAPACITY + 1):
        spl, masked = bkern.capacity_route(S)
        assert spl in (1, 2, 4, 8, 16, 32)
        assert 32 * spl >= S and (spl == 1 or 16 * spl < S)
        assert masked == (S not in bkern.EXACT_CAPACITIES)
    for S in range(bkern.WARP_CAPACITY + 1, 65_537):
        assert bkern.capacity_route(S) == (bkern.BLOCK_ROUTE, False)
    for S in (0, -1):
        with pytest.raises(ValueError, match="at least 1"):
            bkern.capacity_route(S)
    S = bkern.WARP_CAPACITY + 1
    msgs = torch.zeros((1, 4, 8), dtype=torch.int32)
    book = BookState(torch.full((1, 2, 6, S), -1, dtype=torch.int32))
    got = bkern._kernel_inputs(EngineConfig(n_orders=S), msgs, book,
                               torch.zeros((1, 2), dtype=torch.int32), None)
    assert got[1].shape == (1, 2, 6, S) and got[4] is None


@pytest.mark.parametrize("mode", [0, 3])
def test_plain_scans_match_pallas_interpret_at_24(mode):
    """Kernel 1's and kernel 2's plain versions (records at rec_k 16 and
    24, with sweeps) against the Pallas kernels in interpret mode."""
    E, M, S = 128, 12, 24
    book, msgs, prev = make_corner_case(E, M, S, seed=140 + mode)
    _, ttot = check_pallas_interpret(mode, book, msgs, prev)
    assert (ttot[:, 0] != 0).any()
    book, msgs, prev = make_case(E, M, S, seed=150 + mode, fill=0.8)
    msgs = add_sweeps(msgs, every=3, seed=mode)
    counts = check_records_pallas(mode, book, msgs, prev, S)
    assert counts.max() > 16


@pytest.mark.parametrize("S", [2, UPSTREAM])
@pytest.mark.parametrize("mode", [1, 3])
def test_plain_scans_match_xla_engine(S, mode):
    """Both plain versions against the vmapped XLA engine, its forward
    fill, its trade summaries and its log."""
    E, M = 8, 32
    book, msgs, prev = make_corner_case(E, M, S, seed=160 + S + mode,
                                        fill=0.8, shared=True,
                                        fresh_ids=True)
    got = check_xla_engine(mode, book, msgs, prev, wipe_holes=True)
    assert int(got.total_quant.sum()) > 0
    msgs = add_sweeps(msgs, every=2, seed=S, fresh_ids=True)
    check_records_xla(mode, book, msgs, prev, wipe_holes=True,
                      deepest=min(S, 17))


def _world_pair(**world):
    w = dict(WORLD, n_orders=UPSTREAM, **world)
    jenv = JWorldEnv(jcfg.MultiAgentConfig(
        world=jcfg.WorldConfig(**w),
        agents=(jcfg.MarketMakingConfig(), jcfg.ExecutionConfig())))
    tenv = WorldEnv(tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**w),
        agents=(tcfg.MarketMakingConfig(), tcfg.ExecutionConfig())),
        device="cpu")
    return jenv, tenv


def test_step_vec_at_the_upstream_capacity_matches_jax():
    """The 2-player world at 100 orders a side: 3 steps through an
    episode's end, books, rewards and observations as the JAX world's."""
    jenv, tenv = _world_pair()
    assert tenv.wcfg.n_orders == UPSTREAM
    _run_steps(jenv, tenv, 3)


def test_debug_step_at_the_upstream_capacity_matches_jax():
    """``debug_mode`` with cancel mode 3 at 100 orders a side: the records
    scan keeps every fill (``rec_k`` = 100), and the world state's trade
    log equals the JAX world's uncapped one; in the deterministic modes
    ``rec_k`` is 16."""
    jenv, tenv = _world_pair(debug_mode=True, cancel_mode=3)
    assert tenv.rec_k == UPSTREAM
    _run_steps(jenv, tenv, 3)
    det = WorldEnv(tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**dict(
        WORLD, n_orders=UPSTREAM, debug_mode=True, cancel_mode=1))),
        device="cpu")
    assert det.rec_k == 16
