"""The port's book queries and layout helpers, its ``OrderBook`` facade,
fixtures and oracle against the JAX package's.

Every function of ``vit_marl_tpu_torch/lob/book.py`` that the JAX
``lob/book.py`` has runs on the same books as the vmapped JAX function:
sorted-arena books (``torch_cases.make_case``), corner books
(``make_corner_case``: stale planes in holes, INIT_ID and zero order ids,
an ask at 2^31 - 1, quantities of 0 and below and near 2^31) and the same
books with their slots shuffled.  Every result is integer and bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu.config import EngineConfig as JEngineConfig
from vit_marl_tpu.lob import book as jbk
from vit_marl_tpu.lob.oracle import OracleBook as JOracleBook
from vit_marl_tpu.lob.orderbook import OrderBook as JOrderBook
from vit_marl_tpu.ops.book_kernel import _per_message_uniforms
from vit_marl_tpu.utils import fixtures as jfix
from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.lob import OrderBook
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.lob.oracle import OracleBook
from vit_marl_tpu_torch.utils import fixtures as tfix

from test_torch_book_kernel import FIELDS, engine_keys
from torch_cases import make_case, make_corner_case, make_l2_rows

E, M, S = 16, 8, 32
CFG = EngineConfig(n_orders=S)
JCFG = JEngineConfig(n_orders=S)


def books(kind):
    """(E, 2, 6, S) int32 books of one kind."""
    if kind == "case":
        return make_case(E, M, S, seed=1, fill=0.7)[0]
    book = make_corner_case(E, M, S, seed=2, fill=0.7)[0]
    if kind == "corner":
        return book
    # the corner books with every env's slots shuffled (unsorted arenas)
    rng = np.random.default_rng(3)
    perm = np.argsort(rng.random((E, 2, 1, S)), axis=-1)
    return np.take_along_axis(book, np.broadcast_to(perm, book.shape), -1)


KINDS = ("case", "corner", "shuffled")


def sides(book, i):
    """The port's and the JAX package's side ``i`` of ``book``."""
    p = bk.BookState(torch.from_numpy(book)).side(i)
    j = jbk.SideState(*[jnp.asarray(book[:, i, f]) for f in range(6)])
    return p, j


def eq(want, got, what=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=what)


def eq_side(want, got, what=""):
    for f in FIELDS:
        eq(getattr(want, f), getattr(got, f), f"{what} {f}")


def probes(book, i, seed):
    """Per-env lookup arguments: order ids, prices and times of the side's
    slots (holes' stale values among them) and absent ones."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, S, E)
    pick = lambda f: book[np.arange(E), i, f, j]           # noqa: E731
    miss = rng.random(E) < 0.3
    oid = np.where(miss, 777_777, pick(2)).astype(np.int32)
    price = np.where(rng.random(E) < 0.2, 1, pick(0)).astype(np.int32)
    ts = pick(4).astype(np.int32)
    tns = np.where(miss, -5, pick(5)).astype(np.int32)
    return oid, price, ts, tns


@pytest.mark.parametrize("kind", KINDS)
def test_layout_and_sort(kind):
    """``side_to_dense`` / ``side_from_dense``, ``sort_side``,
    ``canonicalize_book``, ``is_sorted_arena``; ``init_side``."""
    book = books(kind)
    for i, is_bid in ((0, False), (1, True)):
        p, j = sides(book, i)
        dense = bk.side_to_dense(p)
        eq(jax.vmap(jbk.side_to_dense)(j), dense, "dense")
        eq_side(jax.vmap(jbk.side_from_dense)(jnp.asarray(dense.numpy())),
                bk.side_from_dense(dense), "from dense")
        js = jax.vmap(lambda s: jbk.sort_side(s, is_bid))(j)
        ps = bk.sort_side(p, is_bid)
        eq_side(js, ps, "sorted")
        eq(jax.vmap(lambda s: jbk.is_sorted_arena(s, is_bid))(j),
           bk.is_sorted_arena(p, is_bid), "is_sorted_arena")
        eq(jax.vmap(lambda s: jbk.is_sorted_arena(s, is_bid))(js),
           bk.is_sorted_arena(ps, is_bid), "is_sorted_arena sorted")
        assert bool(bk.is_sorted_arena(ps, is_bid).all())
    if kind == "shuffled":
        assert not bool(bk.is_sorted_arena(sides(book, 0)[0], False).all())
    jb = jbk.BookState(asks=sides(book, 0)[1], bids=sides(book, 1)[1],
                       trades=jnp.full((E, 4, 8), -1, jnp.int32))
    jc = jax.vmap(jbk.canonicalize_book)(jb)
    pc = bk.canonicalize_book(bk.BookState(torch.from_numpy(book)))
    eq_side(jc.asks, pc.asks, "canonical asks")
    eq_side(jc.bids, pc.bids, "canonical bids")
    eq_side(jax.vmap(lambda _: jbk.init_side(S))(jnp.arange(E)),
            bk.init_side(S, E), "init_side")


@pytest.mark.parametrize("kind", KINDS)
def test_price_and_volume_queries(kind):
    """``best_ask``, ``best_bid``, ``best_bid_and_ask`` and the port's
    ``best_bid_and_ask_incl_quants``, ``volume_at_price``,
    ``init_volume_at_price``, ``top_order_index`` and
    ``get_next_executable_order``."""
    book = books(kind)
    (pa, ja), (pb, jb) = sides(book, 0), sides(book, 1)
    eq(jax.vmap(lambda s: jbk.best_ask(JCFG, s))(ja), bk.best_ask(CFG, pa))
    eq(jax.vmap(lambda s: jbk.best_bid(JCFG, s))(jb), bk.best_bid(CFG, pb))
    want = jax.vmap(lambda a, b: jbk.best_bid_and_ask(JCFG, a, b))(ja, jb)
    for w, g in zip(want, bk.best_bid_and_ask(CFG, pa, pb)):
        eq(w, g, "best_bid_and_ask")
    want = jax.vmap(lambda a, b: jbk.best_bid_and_ask_incl_quants(
        JCFG, a, b))(ja, jb)
    got = bk.best_bid_and_ask_incl_quants(CFG, bk.BookState(
        torch.from_numpy(book)))
    for w, g in zip(want, got):
        eq(w, g, "incl_quants")
    for i, (p, j) in enumerate(((pa, ja), (pb, jb))):
        _, price, _, _ = probes(book, i, seed=10 + i)
        eq(jax.vmap(jbk.volume_at_price)(j, jnp.asarray(price)),
           bk.volume_at_price(p, torch.from_numpy(price)), "volume")
        eq(jax.vmap(lambda s, x: jbk.init_volume_at_price(JCFG, s, x))(
            j, jnp.asarray(price)),
           bk.init_volume_at_price(CFG, p, torch.from_numpy(price)),
           "init volume")
        eq(jax.vmap(lambda s: jbk.top_order_index(JCFG, s, i == 1))(j),
           bk.top_order_index(CFG, p, i == 1), "top_order_index")
        eq(jax.vmap(lambda s: jbk.get_next_executable_order(JCFG, i, s))(j),
           bk.get_next_executable_order(CFG, i, p), "next order")
    # a number as the price, as the JAX function takes one
    eq(jax.vmap(lambda s: jbk.volume_at_price(s, 2_200_100))(ja),
       bk.volume_at_price(pa, 2_200_100), "volume at a number")


@pytest.mark.parametrize("kind", KINDS)
def test_order_lookups(kind):
    """``get_order_by_id`` (-1 rows), ``get_order_by_id_and_price``,
    ``get_order_by_time`` (-2 rows) and ``get_order_ids``."""
    book = books(kind)
    for i in (0, 1):
        p, j = sides(book, i)
        oid, price, ts, tns = probes(book, i, seed=20 + i)
        jo, jp, jt, jn = map(jnp.asarray, (oid, price, ts, tns))
        to, tp, tt, tn = map(torch.from_numpy, (oid, price, ts, tns))
        eq(jax.vmap(jbk.get_order_by_id)(j, jo),
           bk.get_order_by_id(p, to), "by id")
        eq(jax.vmap(jbk.get_order_by_id_and_price)(j, jo, jp),
           bk.get_order_by_id_and_price(p, to, tp), "by id and price")
        got = bk.get_order_by_time(p, tt, tn)
        eq(jax.vmap(jbk.get_order_by_time)(j, jt, jn), got, "by time")
        assert (got.numpy() == -2).all(axis=1).any()
        eq(jax.vmap(jbk.get_order_ids)(j), bk.get_order_ids(p), "ids")


def test_agent_trades():
    rng = np.random.default_rng(4)
    trades = rng.integers(-3, 40, (E, 24, 8)).astype(np.int32)
    trades[rng.random((E, 24)) < 0.3] = -1
    trades[..., 6:] = rng.integers(-3, 3, (E, 24, 2))
    aid = rng.integers(-3, 3, E).astype(np.int32)
    got = bk.get_agent_trades(torch.from_numpy(trades), torch.from_numpy(aid))
    eq(jax.vmap(jbk.get_agent_trades)(jnp.asarray(trades), jnp.asarray(aid)),
       got)
    assert (got.numpy() != 0).any()
    eq(jax.vmap(lambda tr: jbk.get_agent_trades(tr, 2))(jnp.asarray(trades)),
       bk.get_agent_trades(torch.from_numpy(trades), 2), "a number")


# --------------------------------------------------------------------------
# The OrderBook facade
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [1, 3])
def test_orderbook_facade_matches_jax(mode):
    """``OrderBook(device="cpu")`` against the JAX ``OrderBook`` on one
    book: reset from an L2 row, one message, a stream, the stream with its
    L2 state, and every query; the random-cancel uniforms of mode 3 are
    the JAX keys' draws."""
    cfg = EngineConfig(n_orders=S, n_trades=48, cancel_mode=mode)
    ob = OrderBook(cfg, device="cpu")
    job = JOrderBook(JEngineConfig(n_orders=S, n_trades=48,
                                   cancel_mode=mode))
    row = make_l2_rows(1, seed=5 + mode)[0]
    js = job.reset(jnp.asarray(row))
    ps = ob.reset(row)
    key = engine_keys(2, 1)[0]
    _, msgs, _ = make_case(1, 40, S, seed=7 + mode, fill=0.7)
    uni = lambda k, n: _per_message_uniforms(k[None], n)   # noqa: E731

    js = job.process_order_array(js, key, jnp.asarray(msgs[0, 0]))
    u0 = jax.random.uniform(jax.random.split(key)[0])
    ps = ob.process_order_array(ps, msgs[:, 0], uniforms=np.array([u0]))
    js = job.process_orders_array(js, key, jnp.asarray(msgs[0, 1:20]))
    ps = ob.process_orders_array(ps, msgs[:, 1:20],
                                 uniforms=np.array(uni(key, 19)))
    js, jl2 = job.process_orders_array_l2(js, key, jnp.asarray(msgs[0, 20:]),
                                          5)
    ps, pl2 = ob.process_orders_array_l2(ps, msgs[:, 20:], 5,
                                         uniforms=np.array(uni(key, 20)))
    eq(jl2[None], pl2, "l2 after the stream")
    pbook, ptrades = ps
    eq(np.stack([np.stack([np.asarray(getattr(s, f)) for f in FIELDS])
                 for s in (js.asks, js.bids)])[None], pbook.data, "book")
    eq(js.trades[None], ptrades, "trades")
    assert int((ptrades[..., 0] != -1).sum()) > 0
    eq(job.get_l2_state(js)[None], ob.get_l2_state(ps), "l2")
    eq(job.get_vision_l2_state(js, 4)[None], ob.get_vision_l2_state(ps, 4),
       "vision l2")
    for w, g in zip(job.get_best_bid_and_ask(js), ob.get_best_bid_and_ask(ps)):
        eq(np.asarray(w)[None], g, "best bid and ask")
    for side in (-1, 1):
        price = int(pl2[0, 0 if side == -1 else 2])
        eq(np.asarray(job.get_volume_at_price(js, side, price))[None],
           ob.get_volume_at_price(ps, side, price), "volume")
    tid = int(ptrades[0, 0, 6])
    eq(job.get_agent_trades(js, tid)[None], ob.get_agent_trades(ps, tid),
       "agent trades")


def test_orderbook_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OrderBook()
    assert OrderBook(device="cpu").device == torch.device("cpu")


# --------------------------------------------------------------------------
# Fixtures and oracle
# --------------------------------------------------------------------------


def test_fixtures_and_oracle_match_jax():
    """The same numpy seed gives the same books and messages from both
    packages' fixtures, and both oracles the same books and logs on the
    stream made from them."""
    ecfg = EngineConfig(n_orders=24, n_trades=16)
    jcfg = JEngineConfig(n_orders=24, n_trades=16)
    made = []
    for fix, cfg in ((tfix, ecfg), (jfix, jcfg)):
        rng = np.random.default_rng(11)
        asks, bids, trades = fix.random_book(cfg, rng, percent_fill=0.5)
        msgs = []
        for i in range(60):
            k = i % 4
            if k == 0:
                m = fix.random_message(rng, time_s=34_201 + i, oid=-300 - i)
            elif k == 1:
                m = fix.random_aggressive_message(rng, asks, bids,
                                                  time_s=34_201 + i)
            elif k == 2:
                m = fix.random_cancel_for_book(rng, bids, 1,
                                               time_s=34_201 + i)
            else:
                m = fix.random_message(rng, kind="cancel", oid=-300 - i)
            msgs.append(m)
        made.append((asks, bids, trades, np.array(msgs)))
    for a, b in zip(*made):
        np.testing.assert_array_equal(a, b)
    asks, bids, trades, msgs = made[0]
    out = []
    for Oracle, cfg in ((OracleBook, ecfg), (JOracleBook, jcfg)):
        o = Oracle(cfg)
        o.load_dense(asks, bids, trades)
        o.process_all(msgs)
        out.append((o.dense(o.asks), o.dense(o.bids), o.trades))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert (out[0][2][:, 0] != -1).sum() > 0
