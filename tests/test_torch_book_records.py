"""The port's plain book scan in records mode, and the trade log built from
its records, against the JAX package.

The same numpy-made books and message streams go through

- the Pallas kernel ``pallas_process_step`` in interpret mode (as
  ``tests/test_book_kernel.py`` runs it on the CPU) and the JAX
  ``finalize_trade_log_from_records`` over its records, and
- the vmapped XLA engine ``process_messages_save_bidask``, whose trade log
  is uncapped per message,

and through ``vit_marl_tpu_torch.ops.book_kernel.process_step_records``
and ``finalize_trade_log_from_records`` on CPU tensors.  Every output is
integer and must be bit-equal, in all four cancel modes.

The Pallas kernel writes the rows of a message's records only up to the
largest fill count of its block of 128 envs; below that a row past the
env's own fills reads (-1, 0, 0, 0), above it the price plane reads -1 and
planes 1-3 hold stale staging data, which is not part of the function.
The port writes (-1, 0, 0, 0) in every row past the fills.  So the price
plane is compared in every row and planes 1-3 in the rows below the
block's largest fill count.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.config import EngineConfig as JEngineConfig
from vit_marl_tpu.env.common import ffill_best_prices
from vit_marl_tpu.lob import engine as jeng
from vit_marl_tpu.ops.book_kernel import (
    _per_message_uniforms,
    finalize_trade_log_from_records as j_finalize,
    pallas_process_step,
)
from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.ops import book_kernel as bkern

from test_torch_book_kernel import book_array, engine_keys, jax_book
from torch_cases import (add_sweeps, dispatch_index, make_case,
                         make_corner_case)


def run_port(mode, book, msgs, prev, rec_k, uniforms=None):
    u = None if uniforms is None else torch.from_numpy(np.array(uniforms))
    return bkern.process_step_records(
        EngineConfig(n_orders=book.shape[-1], cancel_mode=mode),
        torch.from_numpy(msgs), BookState(torch.from_numpy(book)),
        torch.from_numpy(prev), rec_k, u)


def empty_log(E, cap):
    return np.full((E, cap, 8), -1, np.int32)


def port_log(trades0, recs, msgs, counts):
    return bkern.finalize_trade_log_from_records(
        torch.from_numpy(trades0), recs, torch.from_numpy(msgs),
        counts).numpy()


def jax_log(trades0, recs, msgs, counts):
    return np.asarray(jax.vmap(j_finalize)(
        jnp.asarray(trades0), recs, jnp.asarray(msgs), counts))


def check_records_pallas(mode, book, msgs, prev, rec_k):
    """The port's plain records scan, and the logs finalized from its
    records, against ``pallas_process_step`` in interpret mode on one case;
    returns the fill counts."""
    E, M = msgs.shape[:2]
    S = book.shape[-1]
    keys = engine_keys(mode, E)
    jb, (ja, jbb), (jrec, jcnt) = pallas_process_step(
        JEngineConfig(n_orders=S, cancel_mode=mode), jnp.asarray(msgs),
        jax_book(book, 8), jnp.asarray(prev), True, rec_k,
        engine_keys=keys)
    u = None if keys is None else _per_message_uniforms(keys, M)
    tb, (ta, tbb), (trec, tcnt) = run_port(mode, book, msgs, prev, rec_k, u)
    np.testing.assert_array_equal(book_array(jb), tb.data.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jbb), tbb.numpy())
    jcnt = np.asarray(jcnt)
    np.testing.assert_array_equal(jcnt, tcnt.numpy())
    jrec, trec = np.asarray(jrec), trec.numpy()
    assert trec.shape == jrec.shape == (E, M, rec_k, 4)
    np.testing.assert_array_equal(jrec[..., 0], trec[..., 0])
    defined = (np.arange(rec_k)[None, None, :]
               < jcnt.max(axis=0)[None, :, None])           # (1, M, rec_k)
    defined = np.broadcast_to(defined, (E, M, rec_k))
    np.testing.assert_array_equal(jrec[..., 1:][defined],
                                  trec[..., 1:][defined])
    # past the fills the port's rows are empty
    n = np.minimum(jcnt, rec_k)[..., None]
    past = np.arange(rec_k)[None, None, :] >= n
    assert (trec[past] == np.array(bkern.EMPTY_RECORD)).all()
    # the finalized logs, with room to spare and overflowing the log
    for cap in (96, 8):
        t0 = empty_log(E, cap)
        np.testing.assert_array_equal(
            jax_log(t0, jrec, msgs, jcnt),
            port_log(t0, torch.from_numpy(trec), msgs, tcnt))
    return jcnt


@pytest.mark.parametrize("mode,sweep,rec_k", [
    (0, False, 16), (1, False, 16), (2, False, 16), (3, False, 16),
    (1, True, 16), (1, True, 32)],
    ids=["mode0", "mode1", "mode2", "mode3", "sweep_rec_k16",
         "sweep_rec_k32"])
def test_plain_records_match_pallas_interpret(mode, sweep, rec_k):
    E, M, S = 128, 24 if not sweep else 12, 32
    book, msgs, prev = make_case(E, M, S, seed=20 + mode,
                                 fill=0.8 if sweep else 0.6)
    if sweep:
        msgs = add_sweeps(msgs, seed=mode)
    jcnt = check_records_pallas(mode, book, msgs, prev, rec_k)
    # non-vacuous: fills happened, and the sweeps overflowed rec_k = 16
    assert jcnt.sum() > 0
    if sweep:
        assert jcnt.max() > 16
        assert (jcnt > rec_k).any() == (rec_k == 16)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_records_match_pallas_interpret_on_corners(mode):
    """``torch_cases.make_corner_case`` books and streams with sweeps; a
    message that is no limit order fills where crossing prefix sums wrap
    int32."""
    E, M, S = 128, 16, 32
    book, msgs, prev = make_corner_case(E, M, S, seed=80 + mode)
    msgs = add_sweeps(msgs, every=5, seed=mode)
    jcnt = check_records_pallas(mode, book, msgs, prev, 16)
    assert jcnt.max() > 16
    assert (jcnt[dispatch_index(msgs) >= 2] > 0).any()


def check_records_xla(mode, book, msgs, prev, wipe_holes=False,
                      deepest=17):
    """With ``rec_k = S`` nothing is truncated: the finalized log equals the
    XLA engine's, which records every fill.  ``wipe_holes``: every plane
    of a hole in the engine's book reads EMPTY before the comparison;
    ``deepest``: the most fills of one message must reach it (a book of
    S slots fills at most S a message)."""
    E, M = msgs.shape[:2]
    S = book.shape[-1]
    cfg = JEngineConfig(n_orders=S, n_trades=1024, cancel_mode=mode)
    keys = jax.random.split(jax.random.PRNGKey(5), E)
    xbook, (xa, xb) = jax.jit(jax.vmap(partial(
        jeng.process_messages_save_bidask, cfg, n_last=M)))(
        keys, jnp.asarray(msgs), jax_book(book, cfg.n_trades))
    xa = jax.vmap(ffill_best_prices)(xa, jnp.asarray(prev[:, 0]))
    xb = jax.vmap(ffill_best_prices)(xb, jnp.asarray(prev[:, 1]))
    u = _per_message_uniforms(keys, M) if mode >= 2 else None
    tb, (ta, tbb), (trec, tcnt) = run_port(mode, book, msgs, prev, S, u)
    xarr = book_array(xbook)
    if wipe_holes:
        xarr = np.where(xarr[:, :, :1] == -1, -1, xarr)
    np.testing.assert_array_equal(xarr, tb.data.numpy())
    np.testing.assert_array_equal(np.asarray(xa), ta.numpy())
    np.testing.assert_array_equal(np.asarray(xb), tbb.numpy())
    xlog = np.asarray(xbook.trades)
    n_trades = (xlog[:, :, 0] != -1).sum(1)
    assert deepest <= tcnt.numpy().max() and n_trades.max() < cfg.n_trades
    np.testing.assert_array_equal(n_trades, tcnt.numpy().sum(1))
    np.testing.assert_array_equal(
        xlog, port_log(empty_log(E, cfg.n_trades), trec, msgs, tcnt))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_records_and_log_match_xla_engine(mode):
    """With ``rec_k = S`` nothing is truncated: the finalized log equals the
    XLA engine's, which records every fill."""
    E, M, S = 6, 32, 32
    book, msgs, prev = make_case(E, M, S, seed=30 + mode, fill=0.8)
    msgs = add_sweeps(msgs, every=2, seed=mode)
    check_records_xla(mode, book, msgs, prev)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_records_and_log_match_xla_engine_on_corners(mode):
    """As above on the corners both JAX engines share
    (``make_corner_case(..., shared=True)``)."""
    E, M, S = 8, 32, 32
    book, msgs, prev = make_corner_case(E, M, S, seed=90 + mode, fill=0.8,
                                        shared=True)
    msgs = add_sweeps(msgs, every=2, seed=mode)
    check_records_xla(mode, book, msgs, prev, wipe_holes=True)


def test_finalize_keeps_earlier_rows_and_fills_the_last_slot():
    """A log that already holds rows, and one step that overflows it: the
    JAX package's rule (the last row holds the step's last fill)."""
    E, M, S = 128, 8, 32
    book, msgs, prev = make_case(E, M, S, seed=41, fill=0.8)
    msgs = add_sweeps(msgs, every=2)
    _, _, (recs, counts) = run_port(1, book, msgs, prev, 16)
    rng = np.random.default_rng(0)
    for cap in (4, 64):
        t0 = empty_log(E, cap)
        held = rng.integers(0, cap // 2, E)
        for e in range(E):
            t0[e, :held[e]] = rng.integers(1, 1000, (held[e], 8))
        np.testing.assert_array_equal(
            jax_log(t0, recs.numpy(), msgs, counts.numpy()),
            port_log(t0, recs, msgs, counts))


def test_cpu_tensors_take_the_plain_version():
    book, msgs, prev = make_case(4, 8, 32, seed=5)
    before = bkern.process_step_records.launches
    run_port(1, book, msgs, prev, 16)
    assert bkern.process_step_records.launches == before


def test_records_arguments_are_checked():
    book, msgs, prev = make_case(4, 8, 32, seed=6)
    with pytest.raises(ValueError, match="uniforms"):
        run_port(2, book, msgs, prev, 16)
    for rec_k in (0, 33):
        with pytest.raises(ValueError, match="rec_k"):
            run_port(1, book, msgs, prev, rec_k)
