"""The port's order-book engine (``vit_marl_tpu_torch/lob/engine.py``)
against the JAX package's XLA scan and the sequential oracle.

The same numpy-made books and message streams go through the vmapped JAX
functions ``process_messages_save_bidask``, ``process_messages_save_states``,
``process_messages`` and ``process_message`` and through the port's on CPU
tensors, in all four cancel modes, on ``torch_cases.make_case`` streams and
on ``make_corner_case`` streams with and without ``shared``.  The
random-cancel modes feed the port the JAX engine's own uniforms
(``_per_message_uniforms`` on ``engine_keys``).  Every output is integer
and bit-equal: every plane of the books (the stale planes of holes
included), the best quotes, the saved states and the trade logs, one of
them overflowing.  Then the JAX package's golden cases
(``tests/test_engine.py::TestGolden``) on the port, and the port's oracle
against the port's engine on streams from the port's fixtures.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.config import EngineConfig as JEngineConfig
from vit_marl_tpu.lob import book as jbk
from vit_marl_tpu.lob import engine as jeng
from vit_marl_tpu.ops.book_kernel import (
    _per_message_uniforms,
    pallas_process_step_aggs,
)
from vit_marl_tpu_torch.config import CancelMode, EngineConfig
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.lob import engine as eng
from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.lob.oracle import OracleBook
from vit_marl_tpu_torch.utils.fixtures import (
    random_aggressive_message,
    random_book,
    random_cancel_for_book,
    random_message,
)

from test_torch_book_kernel import (book_array, engine_keys, jax_book,
                                   run_port)
from torch_cases import (TICK, TIDS, add_sweeps, engine_against_records,
                         make_case, make_corner_case)

E, M, S = 8, 24, 32
CAP_ROOM, CAP_OVERFLOW = 96, 8
CASES = ("case", "corner_shared", "corner")


@functools.lru_cache(maxsize=None)
def jfn(name, mode, cap, n_last=None):
    """The vmapped, jitted JAX function, made once per (name, mode, cap,
    n_last) so that the cases of one mode share its compile."""
    cfg = JEngineConfig(n_orders=S, n_trades=cap, cancel_mode=mode)
    f = partial(getattr(jeng, name), cfg)
    if n_last is not None:
        f = partial(f, n_last=n_last)
    return jax.jit(jax.vmap(f))


def make(kind, mode):
    seed = 40 + 3 * mode + CASES.index(kind)
    if kind == "case":
        return make_case(E, M, S, seed=seed, fill=0.8)
    return make_corner_case(E, M, S, seed=seed, fill=0.8,
                            shared=kind == "corner_shared")


def prefilled_log(cap, n, seed):
    """A trade log whose first ``n`` rows hold trades."""
    rng = np.random.default_rng(seed)
    log = np.full((E, cap, 8), -1, np.int32)
    log[:, :n] = rng.integers(0, 10**6, (E, n, 8))
    return log


def jbook(book, trades):
    return jax_book(book, trades.shape[1]).replace(trades=jnp.asarray(trades))


def t(x):
    return torch.from_numpy(np.array(x))


def eq(want, got, what):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=what)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_engine_matches_xla_engine(mode, kind):
    book, msgs, _ = make(kind, mode)
    keys = engine_keys(2, E)         # the XLA engine takes keys in any mode
    u = t(_per_message_uniforms(keys, M)) if mode >= 2 else None
    cfg = EngineConfig(n_orders=S, cancel_mode=mode)
    pbook, pmsgs = BookState(t(book)), t(msgs)
    jmsgs = jnp.asarray(msgs)

    # best quotes after every message, room in the log
    empty = np.full((E, CAP_ROOM, 8), -1, np.int32)
    xb, (xa, xbb) = jfn("process_messages_save_bidask", mode, CAP_ROOM, M)(
        keys, jmsgs, jbook(book, empty))
    pb, pt, (pa, pbb) = eng.process_messages_save_bidask(
        cfg, pmsgs, pbook, t(empty), M, u)
    eq(book_array(xb), pb.data, "book")
    eq(xb.trades, pt, "trades")
    eq(xa, pa, "best asks")
    eq(xbb, pbb, "best bids")
    n_fills = (np.asarray(xb.trades)[..., 0] != -1).sum(1)
    assert n_fills.max() < CAP_ROOM and n_fills.sum() > 0

    # the log overflows behind two earlier trades
    log0 = prefilled_log(CAP_OVERFLOW, 2, seed=mode)
    xb2 = jfn("process_messages", mode, CAP_OVERFLOW)(
        keys, jmsgs, jbook(book, log0))
    pb2, pt2 = eng.process_messages(cfg, pmsgs, pbook, t(log0), u)
    eq(book_array(xb2), pb2.data, "book")
    eq(xb2.trades, pt2, "overflowing trades")
    assert (n_fills > CAP_OVERFLOW - 2).any()

    # the last half of the states
    xas, xbs, xt = jfn("process_messages_save_states", mode, CAP_ROOM,
                       M // 2)(keys, jmsgs, jbook(book, empty))
    pas, pbs, ptr = eng.process_messages_save_states(
        cfg, pmsgs, pbook, t(empty), M // 2, u)
    for f in ("price", "quant", "oid", "tid", "time_s", "time_ns"):
        eq(getattr(xas, f), getattr(pas, f), f"asks {f}")
        eq(getattr(xbs, f), getattr(pbs, f), f"bids {f}")
    eq(xt, ptr, "trades")

    # one message (the stream's first) on the prefilled log
    k0 = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    u0 = t(jax.vmap(jax.random.uniform)(k0)) if mode >= 2 else None
    xb1 = jfn("process_message", mode, CAP_OVERFLOW)(
        jbook(book, log0), keys, jmsgs[:, 0])
    pb1, pt1 = eng.process_message(cfg, pbook, t(log0), pmsgs[:, 0], u0)
    eq(book_array(xb1), pb1.data, "book")
    eq(xb1.trades, pt1, "trades")


def test_random_modes_take_uniforms_or_a_generator():
    book, msgs, _ = make_case(4, 6, S, seed=5)
    cfg = EngineConfig(n_orders=S, cancel_mode=CancelMode.CANCEL_UNIFORM)
    trades = bk.init_trades(cfg, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="uniforms"):
        eng.process_messages(cfg, t(msgs), BookState(t(book)), trades)
    drawn = torch.rand((6, 4), generator=torch.Generator().manual_seed(3))
    want = eng.process_messages(cfg, t(msgs), BookState(t(book)), trades,
                                uniforms=drawn)
    got = eng.process_messages(cfg, t(msgs), BookState(t(book)), trades,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(want[0].data, got[0].data)
    assert torch.equal(want[1], got[1])


# --------------------------------------------------------------------------
# The golden cases of tests/test_engine.py
# --------------------------------------------------------------------------

INIT = EngineConfig().init_id


def msg(type_, side, quant, price, oid=-300, tid=-300, ts=34_201, tns=0):
    return [type_, side, quant, price, oid, tid, ts, tns]


def _pad(rows, n, width):
    arr = np.full((n, width), -1, dtype=np.int32)
    rows = np.asarray(rows, dtype=np.int32).reshape(-1, width)
    arr[: len(rows)] = rows
    return arr


def occupied(side):
    return side[side[:, 0] != -1]


def book_rows(asks, bids, trades):
    rows = lambda a: sorted(map(tuple, occupied(a)))       # noqa: E731
    return rows(asks), rows(bids), sorted(map(tuple, occupied(trades)))


NOOP_BOOK = random_book(EngineConfig(n_orders=20, n_trades=20),
                        np.random.default_rng(1))

# name: (config kwargs, asks, bids, trades, [(message, check(asks, bids,
# trades, start)), ...]); each check reads the dense views of env 0
GOLDEN = {
    "add_limit_to_empty_book": ({}, None, None, None, [
        (msg(1, 1, 10, 100_000), lambda a, b, tr, s: (
            (b[0] == [100_000, 10, -300, -300, 34_201, 0]).all()
            and (b[1:] == -1).all() and (a == -1).all()
            and (tr == -1).all()))]),
    "full_match_single_order": ({}, [[100_000, 10, -10, -10, 34_200, 0]],
                                None, None, [
        (msg(1, 1, 10, 100_000), lambda a, b, tr, s: (
            (a == -1).all() and (b == -1).all()
            and (tr[0] == [100_000, -10, -10, -300, 34_201, 0, -10,
                           -300]).all()))]),
    "partial_fill_remainder_added": ({}, [[100_000, 4, -10, -10, 34_200, 0]],
                                     None, None, [
        (msg(1, 1, 10, 100_100), lambda a, b, tr, s: (
            (b[0] == [100_100, 6, -300, -300, 34_201, 0]).all()
            and tr[0][1] == -4))]),
    "partial_fill_standing_order_survives": (
        {}, [[100_000, 50, -10, -10, 34_200, 0]], None, None, [
            (msg(1, 1, 10, 100_000), lambda a, b, tr, s: (
                (a[0] == [100_000, 40, -10, -10, 34_200, 0]).all()
                and (b == -1).all()))]),
    "price_priority": ({}, [[100_200, 5, -10, -10, 34_200, 0],
                            [100_000, 5, -11, -11, 34_200, 5]], None, None, [
        (msg(1, 1, 7, 100_200), lambda a, b, tr, s: (
            tr[0][0] == 100_000 and tr[0][1] == -5
            and tr[1][0] == 100_200 and tr[1][1] == -2))]),
    "time_priority_tiebreak": ({}, [[100_000, 5, -10, -10, 34_200, 10],
                                    [100_000, 5, -11, -11, 34_200, 3]],
                               None, None, [
        (msg(1, 1, 5, 100_000), lambda a, b, tr, s: tr[0][2] == -11)]),
    "slot_index_tiebreak": ({}, [[100_000, 5, -10, -10, 34_200, 0],
                                 [100_000, 5, -11, -11, 34_200, 0]],
                            None, None, [
        (msg(1, 1, 5, 100_000), lambda a, b, tr, s: tr[0][2] == -10)]),
    "ask_side_aggressor_sign": ({}, None, [[100_000, 10, -10, -10, 34_200,
                                            0]], None, [
        (msg(1, -1, 6, 100_000), lambda a, b, tr, s: tr[0][1] == 6)]),
    "match_type_is_opposite_side_limit": (
        {}, None, [[100_000, 10, -10, -10, 34_200, 0]], None, [
            (msg(4, 1, 10, 100_000), lambda a, b, tr, s: (
                (b == -1).all() and tr[0][1] == -10))]),
    "cancel_strict_by_id": ({}, None, [[100_000, 10, -50, -50, 34_200, 0]],
                            None, [
        (msg(2, 1, 4, 100_000, oid=-50), lambda a, b, tr, s: b[0][1] == 6),
        (msg(2, 1, 6, 100_000, oid=-50),
         lambda a, b, tr, s: (b == -1).all())]),
    "delete_is_cancel": ({}, None, [[100_000, 10, -50, -50, 34_200, 0]],
                         None, [
        (msg(3, 1, 10, 100_000, oid=-50),
         lambda a, b, tr, s: (b == -1).all())]),
    "cancel_falls_back_to_init_order": (
        {}, None, [[100_000, 10, INIT, INIT, 34_200, 0]], None, [
            (msg(2, 1, 4, 100_000, oid=-777),
             lambda a, b, tr, s: b[0][1] == 6)]),
    "cancel_init_fallback_needs_enough_quantity": (
        {}, None, [[100_000, 3, INIT, INIT, 34_200, 0]], None, [
            (msg(2, 1, 4, 100_000, oid=-777),
             lambda a, b, tr, s: b[0][1] == 3)]),
    "cancel_strict_mode_ignores_inits": (
        {"cancel_mode": CancelMode.STRICT_BY_ID}, None,
        [[100_000, 10, INIT, INIT, 34_200, 0]], None, [
            (msg(2, 1, 4, 100_000, oid=-777),
             lambda a, b, tr, s: b[0][1] == 10)]),
    "noop_message": ({}, NOOP_BOOK[0], NOOP_BOOK[1], NOOP_BOOK[2], [
        ([0] * 8, lambda a, b, tr, s: book_rows(a, b, tr) == s)]),
    "crossing_stops_at_price": ({}, [[100_000, 5, -10, -10, 34_200, 0],
                                     [100_100, 5, -11, -11, 34_200, 0],
                                     [100_300, 5, -12, -12, 34_200, 0]],
                                None, None, [
        (msg(1, 1, 100, 100_100), lambda a, b, tr, s: (
            (occupied(a)[:, 0] == 100_300).all()
            and occupied(b)[0, 1] == 90))]),
    "trade_log_overflow_keeps_last": (
        {"n_orders": 8, "n_trades": 3},
        [[100_000 + i, 1, -10 - i, -10 - i, 34_200, 0] for i in range(5)],
        None, None, [
            (msg(1, 1, 5, 100_004), lambda a, b, tr, s: (
                tr[0][2] == -10 and tr[1][2] == -11 and tr[2][2] == -14))]),
    "book_overflow_overwrites_last_slot": (
        {"n_orders": 2, "n_trades": 4}, None,
        [[100_000, 5, -10, -10, 34_200, 0], [99_000, 5, -11, -11, 34_200, 0]],
        None, [
            (msg(1, 1, 7, 98_000), lambda a, b, tr, s: (
                (b[0] == [100_000, 5, -10, -10, 34_200, 0]).all()
                and (b[1] == [98_000, 7, -300, -300, 34_201, 0]).all()))]),
}


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_cases(name):
    """Each golden case on the port (one env), its checks as
    ``tests/test_engine.py`` states them, and every step bit-equal to the
    JAX engine's ``process_message``."""
    kwargs, asks, bids, trades, steps = GOLDEN[name]
    cfg = EngineConfig(**{"n_orders": 20, "n_trades": 20, **kwargs})
    jcfg = JEngineConfig(**{"n_orders": 20, "n_trades": 20, **kwargs})
    dense = lambda rows, n, w: _pad([] if rows is None else rows, n, w)  # noqa
    a0, b0 = dense(asks, cfg.n_orders, 6), dense(bids, cfg.n_orders, 6)
    tr0 = dense(trades, cfg.n_trades, 8)
    pbook = bk.canonicalize_book(bk.book_from_sides(
        bk.side_from_dense(t(a0[None])), bk.side_from_dense(t(b0[None]))))
    ptr = t(tr0[None])
    jb = jbk.canonicalize_book(jbk.init_book(jcfg).replace(
        asks=jbk.side_from_dense(jnp.asarray(a0)),
        bids=jbk.side_from_dense(jnp.asarray(b0)), trades=jnp.asarray(tr0)))
    start = book_rows(a0, b0, tr0)
    for m, check in steps:
        pbook, ptr = eng.process_message(cfg, pbook, ptr,
                                         torch.tensor([m], dtype=torch.int32))
        jb = jeng.process_message(jcfg, jb, jax.random.PRNGKey(0),
                                  jnp.asarray(m, jnp.int32))
        eq(book_array(jax.tree.map(lambda v: v[None], jb)), pbook.data,
           "book")
        eq(jb.trades[None], ptr, "trades")
        pa = bk.side_to_dense(pbook.asks)[0].numpy()
        pb = bk.side_to_dense(pbook.bids)[0].numpy()
        assert check(pa, pb, ptr[0].numpy(), start)


# --------------------------------------------------------------------------
# The oracle against the engine (deterministic cancel modes)
# --------------------------------------------------------------------------


def stream(rng, asks, bids, n):
    """``tests/test_engine.py::test_differential_random_streams``' mix."""
    msgs, ts, oid = [], 34_201, -300
    for _ in range(n):
        roll = rng.random()
        if roll < 0.45:
            m = random_message(rng, time_s=ts, oid=oid, tid=oid, kind="limit")
        elif roll < 0.6:
            m = random_aggressive_message(rng, asks, bids, time_s=ts, oid=oid)
        elif roll < 0.8:
            side_arr = asks if rng.random() < 0.5 else bids
            sign = -1 if side_arr is asks else 1
            m = random_cancel_for_book(rng, side_arr, sign, time_s=ts)
        elif roll < 0.9:
            m = random_message(rng, time_s=ts, oid=oid, tid=oid, kind="match")
        else:
            m = random_message(rng, time_s=ts, oid=oid, tid=oid, kind="noop")
        msgs.append(m)
        ts += 1
        oid -= 1
    return msgs


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("tiny", [False, True], ids=["mixed", "tiny_book"])
def test_oracle_matches_engine(mode, tiny):
    """12 envs, one seed each: ``random_book`` books and 120 mixed
    messages, or 6-slot books with 5-row logs under 80 random messages
    (the overflow paths), through the batched engine and each env's
    ``OracleBook``; the canonical books and the logs equal."""
    n_env = 12
    cfg = (EngineConfig(n_orders=6, n_trades=5, cancel_mode=mode) if tiny
           else EngineConfig(n_orders=24, n_trades=24, cancel_mode=mode))
    books, streams = [], []
    for e in range(n_env):
        rng = np.random.default_rng(100 * tiny + e)
        if tiny:
            asks, bids, trades = random_book(cfg, rng, percent_fill=0.8,
                                             n_levels=3)
            msgs = [random_message(rng, time_s=34_201 + i, oid=-300 - i,
                                   tid=-300 - i, n_levels=4,
                                   quant_range=(1, 800)) for i in range(80)]
        else:
            asks, bids, trades = random_book(cfg, rng, percent_fill=0.4)
            msgs = stream(rng, asks, bids, 120)
        books.append((asks, bids, trades))
        streams.append(msgs)
    stack = lambda i: t(np.stack([b[i] for b in books]))   # noqa: E731
    book = bk.canonicalize_book(bk.book_from_sides(
        bk.side_from_dense(stack(0)), bk.side_from_dense(stack(1))))
    book, trades = eng.process_messages(
        cfg, t(np.array(streams, np.int32)), book, stack(2).to(torch.int32))
    asks = bk.side_to_dense(bk.sort_side(book.asks, is_bid=False)).numpy()
    bids = bk.side_to_dense(bk.sort_side(book.bids, is_bid=True)).numpy()
    for e in range(n_env):
        oracle = OracleBook(cfg)
        oracle.load_dense(*books[e])
        oracle.process_all(streams[e])
        np.testing.assert_array_equal(asks[e], oracle.dense(oracle.asks))
        np.testing.assert_array_equal(bids[e], oracle.dense(oracle.bids))
        np.testing.assert_array_equal(trades[e].numpy(), oracle.trades)
    assert int((trades[..., 0] != -1).sum()) > 0
    assert int((book.data[:, :, 0] != -1).sum()) > 0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_engine_matches_records_scan_on_shared_corners(mode):
    """The engine against the book scan in records mode at ``rec_k = S``
    and the log built from its records (the plain version here; the card
    runs kernel 2 through the same check), on streams with sweeps."""
    book, msgs, prev = make_corner_case(E, M, S, seed=60 + mode, fill=0.8,
                                        shared=True, fresh_ids=True)
    msgs = add_sweeps(msgs, every=3, seed=mode, fresh_ids=True)
    u = (torch.rand((M, E), generator=torch.Generator().manual_seed(mode))
         if mode >= 2 else None)
    n, most = engine_against_records(
        EngineConfig(n_orders=S, cancel_mode=mode), t(msgs),
        BookState(t(book)), t(prev), u, n_trades=512)
    assert n > 0 and most > S // 2


def order_id_corner(kind, n_envs):
    """``n_envs`` envs, each: one ask; on the bid side a live bid in slot
    0, a hole in slot 1 and a live bid in slot 2; one cancel of 40 of the
    slot-2 bid by its order id.  ``empty_id``: the bid's id is -1, the
    hole's too (an empty slot); ``stale_id``: the hole's stale planes hold
    the bid's id; ``distinct_ids``: they hold another."""
    oid, hole_oid = {"empty_id": (-1, -1), "stale_id": (10_500, 10_500),
                     "distinct_ids": (10_600, 10_500)}[kind]
    book = np.full((n_envs, 2, 6, S), -1, np.int32)
    book[:, 0, :, 0] = [2_200_100, 50, 10_001, 10_001, 34_200, 1]
    book[:, 1, :, 0] = [2_199_900, 100, 10_000, 10_000, 34_200, 2]
    book[:, 1, 1:, 1] = [7, hole_oid, 3, 34_100, 9]       # price -1: a hole
    book[:, 1, :, 2] = [2_199_800, 100, oid, 7, 34_201, 3]
    msgs = np.zeros((n_envs, M, 8), np.int32)
    msgs[:, 0] = [2, 1, 40, 2_199_800, oid, 7, 34_300, 0]
    prev = np.tile(np.array([[2_200_100, 2_199_900]], np.int32), (n_envs, 1))
    return book, msgs, prev


@pytest.mark.parametrize("kind", ["empty_id", "stale_id", "distinct_ids"])
@pytest.mark.parametrize("mode", [0, 3])
def test_engines_differ_on_order_id_corners(mode, kind):
    """The JAX package's two engines on a cancel whose order id a hole
    before the live order also holds: its Pallas kernel (interpret mode)
    cancels the live order, its XLA scan matches the hole and leaves the
    order as it was.  The port's plain book scan equals the Pallas kernel,
    the port's engine equals the XLA scan on every plane; with distinct
    ids all four agree (holes wiped).  This is why
    ``make_corner_case(..., shared=True, fresh_ids=True)`` keeps these ids
    out where the engine is held against the book scan.  The match by
    order id is the first stage of every cancel mode: modes 0 and 3 (no
    fallback, and all of them) stand for the others.  The kernels run
    128 envs (the Pallas kernel's env block), the engines the first E."""
    book, msgs, prev = order_id_corner(kind, 128)
    keys = engine_keys(2, 128)
    u = _per_message_uniforms(keys, M) if mode >= 2 else None
    pal, _, _ = pallas_process_step_aggs(
        JEngineConfig(n_orders=S, cancel_mode=mode), jnp.asarray(msgs),
        jax_book(book, 8), jnp.asarray(TIDS, jnp.int32), jnp.asarray(prev),
        TICK, True, engine_keys=keys if mode >= 2 else None)
    pal = book_array(pal)
    scan, _, _ = run_port(mode, book, msgs, prev, u)
    np.testing.assert_array_equal(pal, scan.data.numpy())

    book, msgs, pal, keys = book[:E], msgs[:E], pal[:E], keys[:E]
    u = None if u is None else u[:, :E]

    empty = np.full((E, CAP_ROOM, 8), -1, np.int32)
    xla, _ = jfn("process_messages_save_bidask", mode, CAP_ROOM, M)(
        keys, jnp.asarray(msgs), jbook(book, empty))
    xla = book_array(xla)
    port, trades, _ = eng.process_messages_save_bidask(
        EngineConfig(n_orders=S, cancel_mode=mode), t(msgs),
        BookState(t(book)), t(empty), M, None if u is None else t(u))
    eq(xla, port.data, "book")
    assert int((trades[..., 0] != -1).sum()) == 0

    assert (pal[:, 1, 1, 2] == 60).all()          # the kernel cancels 40
    wiped = np.where(xla[:, :, :1] == -1, -1, xla)
    if kind == "distinct_ids":
        np.testing.assert_array_equal(wiped, pal)
    else:
        assert (xla[:, 1, 1, 2] == 100).all()     # the XLA scan does not
        assert (xla[:, 1, :, 1] == -1).all()      # but wipes the hole
