"""The book scan past 1,024 orders a side (the CUDA kernel's block route)
against the JAX package.

The port's plain versions of kernels 1 and 2 (aggregate and records mode)
at S=1,032 and 2,048 meet the vmapped XLA engine on the corners both JAX
engines share with fresh order ids (``make_corner_case(...,
shared=True, fresh_ids=True)``): books, forward-filled best quotes, trade
summaries, and the log built from the records of every fill
(``rec_k = S``).  The port's ``step_vec`` at ``n_orders=1,032`` meets
the JAX ``step_vec`` (its XLA scan on the CPU) for 2 steps on replayed
draws.  On the card, ``tests/test_torch_kernel_gpu.py`` holds the block
route bit-equal to these plain versions.

Tolerances: every book, best quote, sum, record and trade log bit-equal;
float observations, rewards and state within atol/rtol 1e-5 (float32),
as in ``tests/test_torch_env.py``.
"""

import pytest

from test_torch_book_kernel import check_xla_engine
from test_torch_book_records import check_records_xla
from test_torch_env import WORLD, _run_steps
from torch_cases import add_sweeps, make_corner_case
from vit_marl_tpu import config as jcfg
from vit_marl_tpu.env.world import WorldEnv as JWorldEnv
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.ops import book_kernel as bkern

DEEP = 1032     # the first multiple of 8 past a warp's 1,024 slots


@pytest.mark.parametrize("S", [DEEP, 2048])
@pytest.mark.parametrize("mode", [1, 3])
def test_plain_scans_past_a_warp_match_xla_engine(S, mode):
    """Both plain versions against the vmapped XLA engine: its books, its
    forward fill and trade summaries, and its log (every fill recorded;
    one message sweeps a side of a quarter-full book)."""
    assert bkern.capacity_route(S) == (bkern.BLOCK_ROUTE, False)
    E, M = 4, 48
    book, msgs, prev = make_corner_case(E, M, S, seed=170 + S + mode,
                                        fill=0.25, shared=True,
                                        fresh_ids=True)
    got = check_xla_engine(mode, book, msgs, prev, wipe_holes=True)
    assert int(got.total_quant.sum()) > 0
    msgs = add_sweeps(msgs, every=3, seed=S, fresh_ids=True)
    check_records_xla(mode, book, msgs, prev, wipe_holes=True, deepest=S // 8)


def test_step_vec_past_a_warp_matches_jax():
    """The 2-player world at 1,032 orders a side: 2 steps, books, rewards
    and observations as the JAX world's."""
    w = dict(WORLD, n_orders=DEEP)
    jenv = JWorldEnv(jcfg.MultiAgentConfig(
        world=jcfg.WorldConfig(**w),
        agents=(jcfg.MarketMakingConfig(), jcfg.ExecutionConfig())))
    tenv = WorldEnv(tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**w),
        agents=(tcfg.MarketMakingConfig(), tcfg.ExecutionConfig())),
        device="cpu")
    assert tenv.wcfg.n_orders == DEEP and not jenv.pallas_ok
    _run_steps(jenv, tenv, 2)
