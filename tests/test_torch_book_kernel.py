"""The port's plain book scan against the JAX package's engines.

The same numpy-made books and message streams go through

- the Pallas kernel ``pallas_process_step_aggs`` in interpret mode (as
  ``tests/test_book_kernel.py`` runs it on the CPU), and
- the vmapped XLA engine ``process_messages_save_bidask`` plus
  ``ffill_best_prices`` and ``summarize_trades`` over its trade log,

and through ``vit_marl_tpu_torch.ops.book_kernel.process_step_aggs`` on CPU
tensors (its plain PyTorch version).  Every output is integer and must be
bit-equal, in all four cancel modes; the random-cancel modes feed the port
the JAX package's own uniforms.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.config import EngineConfig as JEngineConfig
from vit_marl_tpu.env.common import ffill_best_prices, summarize_trades
from vit_marl_tpu.lob import book as jbk
from vit_marl_tpu.lob import engine as jeng
from vit_marl_tpu.ops.book_kernel import (
    _per_message_uniforms,
    pallas_process_step_aggs,
)
from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.env import common as tcommon
from vit_marl_tpu_torch.env.common import summary_from_aggs
from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.ops import book_kernel as bkern

from torch_cases import TICK, TIDS, make_case, make_corner_case

FIELDS = ("price", "quant", "oid", "tid", "time_s", "time_ns")


def jax_book(book, n_trades):
    side = lambda i: jbk.SideState(  # noqa: E731
        *[jnp.asarray(book[:, i, f]) for f in range(6)])
    E = book.shape[0]
    return jbk.BookState(asks=side(0), bids=side(1),
                         trades=jnp.full((E, n_trades, 8), -1, jnp.int32))


def book_array(b: jbk.BookState) -> np.ndarray:
    side = lambda s: np.stack(  # noqa: E731
        [np.asarray(getattr(s, f)) for f in FIELDS], 1)
    return np.stack([side(b.asks), side(b.bids)], 1)


def run_port(mode, book, msgs, prev, uniforms=None):
    u = None if uniforms is None else torch.from_numpy(np.array(uniforms))
    return bkern.process_step_aggs(
        EngineConfig(n_orders=book.shape[-1], cancel_mode=mode),
        torch.from_numpy(msgs), BookState(torch.from_numpy(book)),
        torch.tensor(TIDS, dtype=torch.int32), torch.from_numpy(prev),
        TICK, u)


def engine_keys(mode, E):
    return (jax.random.split(jax.random.PRNGKey(7), E) if mode >= 2
            else None)


def check_pallas_interpret(mode, book, msgs, prev):
    """The port's plain scan against ``pallas_process_step_aggs`` in
    interpret mode on one case; returns the port's per-agent sums and
    totals."""
    E, M = msgs.shape[:2]
    S = book.shape[-1]
    keys = engine_keys(mode, E)
    jb, (ja, jbb), (jag, jtot) = pallas_process_step_aggs(
        JEngineConfig(n_orders=S, cancel_mode=mode), jnp.asarray(msgs),
        jax_book(book, 8), jnp.asarray(TIDS, jnp.int32), jnp.asarray(prev),
        TICK, True, engine_keys=keys)
    u = None if keys is None else _per_message_uniforms(keys, M)
    tb, (ta, tbb), (tag, ttot) = run_port(mode, book, msgs, prev, u)
    np.testing.assert_array_equal(book_array(jb), tb.data.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jbb), tbb.numpy())
    np.testing.assert_array_equal(np.asarray(jag), tag.numpy())
    np.testing.assert_array_equal(np.asarray(jtot), ttot.numpy())
    return tag, ttot


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_scan_matches_pallas_interpret(mode):
    E, M, S = 128, 24, 32
    book, msgs, prev = make_case(E, M, S, seed=mode)
    tag, ttot = check_pallas_interpret(mode, book, msgs, prev)
    # non-vacuous: fills happened and involved both traders
    assert int(ttot[:, 0].sum()) > 0
    assert (tag[:, :, 4].sum(dim=0) > 0).all()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_scan_matches_pallas_interpret_on_corners(mode):
    """Books with live quantities of 0 and below, stale planes in holes,
    shared INIT_ID and zero order ids, quantities whose crossing prefix
    sums wrap int32, and messages of every (type, side)
    (``torch_cases.make_corner_case``)."""
    E, M, S = 128, 24, 32
    book, msgs, prev = make_corner_case(E, M, S, seed=60 + mode)
    tag, ttot = check_pallas_interpret(mode, book, msgs, prev)
    # non-vacuous: fills happened (sums may wrap) and involved both traders
    assert (ttot[:, 0] != 0).any()
    assert (tag[:, :, 4] != 0).any(dim=0).all()


def check_xla_engine(mode, book, msgs, prev, wipe_holes=False):
    """The port's plain scan against the vmapped XLA engine, its forward
    fill and ``summarize_trades`` over its trade log, on one case; returns
    the port's trade summary.  ``wipe_holes``: every plane of a hole in the
    engine's book reads EMPTY before the comparison (the engine leaves the
    stale planes of an input book's holes as they are)."""
    E, M = msgs.shape[:2]
    S = book.shape[-1]
    cfg = JEngineConfig(n_orders=S, n_trades=2048, cancel_mode=mode)
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    xbook, (xa, xb) = jax.jit(jax.vmap(partial(
        jeng.process_messages_save_bidask, cfg, n_last=M)))(
        keys, jnp.asarray(msgs), jax_book(book, cfg.n_trades))
    assert int((np.asarray(xbook.trades)[:, :, 0] != -1).sum(1).max()) \
        < cfg.n_trades
    # the port's plain forward fill on the engine's raw best prices
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(ffill_best_prices)(xa, jnp.asarray(prev[:, 0]))),
        tcommon.ffill_best_prices(torch.from_numpy(np.array(xa)),
                                  torch.from_numpy(prev[:, 0])).numpy())
    xa = jax.vmap(ffill_best_prices)(xa, jnp.asarray(prev[:, 0]))
    xb = jax.vmap(ffill_best_prices)(xb, jnp.asarray(prev[:, 1]))
    u = _per_message_uniforms(keys, M) if mode >= 2 else None
    tb, (ta, tbb), (tag, ttot) = run_port(mode, book, msgs, prev, u)
    xarr = book_array(xbook)
    if wipe_holes:
        xarr = np.where(xarr[:, :, :1] == -1, -1, xarr)
    np.testing.assert_array_equal(xarr, tb.data.numpy())
    np.testing.assert_array_equal(np.asarray(xa), ta.numpy())
    np.testing.assert_array_equal(np.asarray(xb), tbb.numpy())
    got = summary_from_aggs(tag, ttot[:, None, :].expand(E, len(TIDS), 2))
    for k, tid in enumerate(TIDS):
        want = jax.vmap(summarize_trades, in_axes=(0, None, None))(
            xbook.trades, jnp.int32(tid), TICK)
        port_log = tcommon.summarize_trades(
            torch.from_numpy(np.array(xbook.trades)),
            torch.full((E,), tid, dtype=torch.int32), TICK)
        for name, w, g, p in zip(want._fields, want, got, port_log):
            np.testing.assert_array_equal(np.asarray(w), g[:, k].numpy(),
                                          err_msg=name)
            np.testing.assert_array_equal(np.asarray(w), p.numpy(),
                                          err_msg=name)
    return got


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_scan_matches_xla_engine(mode):
    E, M, S = 6, 32, 32
    book, msgs, prev = make_case(E, M, S, seed=10 + mode, fill=0.8)
    got = check_xla_engine(mode, book, msgs, prev)
    assert int(got.agent_quant_abs.sum()) > 0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_scan_matches_xla_engine_on_corners(mode):
    """As above on the corners both JAX engines share
    (``make_corner_case(..., shared=True)``: stale planes in holes, INIT_ID
    and zero order ids, an ask at 2^31 - 1, every (type, side))."""
    E, M, S = 8, 32, 32
    book, msgs, prev = make_corner_case(E, M, S, seed=70 + mode, fill=0.8,
                                        shared=True)
    got = check_xla_engine(mode, book, msgs, prev, wipe_holes=True)
    assert int(got.agent_quant_abs.sum()) > 0


def test_cpu_tensors_take_the_plain_version():
    book, msgs, prev = make_case(4, 8, 32, seed=5)
    before = bkern.process_step_aggs.launches
    run_port(1, book, msgs, prev)
    assert bkern.process_step_aggs.launches == before


def test_random_cancel_modes_require_uniforms():
    book, msgs, prev = make_case(4, 8, 32, seed=6)
    with pytest.raises(ValueError, match="uniforms"):
        run_port(2, book, msgs, prev)


def test_kernel_source_and_build_dir_live_in_the_package():
    assert bkern.SOURCE.endswith("ops/csrc/book_scan.cu")
    assert bkern.BUILD_DIR.endswith("vit_marl_tpu_torch/_build")
