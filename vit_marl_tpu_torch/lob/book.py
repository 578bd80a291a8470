"""Order-book state for a batch of environments, and its queries.

Port of ``vit_marl_tpu/lob/book.py``.  The JAX
package keeps each side as six ``(n_orders,)`` int32 vectors and adds the
env axis with ``vmap``; the port keeps the whole batch in one int32 tensor
``data`` of shape ``(E, 2, 6, S)``: env, side (ask, bid), field (price,
quant, oid, tid, time_s, time_ns), slot.  That is the layout the book-scan
kernel reads (one env's book is contiguous), and :class:`SideState` views
give the reference's field names.

Conventions are the reference's: empty slots are ``-1`` in every field,
occupied slots are in price-time priority order with holes anywhere (the
sorted-arena invariant, ``vit_marl_tpu/lob/engine.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from vit_marl_tpu_torch.config import (EMPTY_SLOT, EngineConfig, MsgCol,
                                       TradeCol)
from vit_marl_tpu_torch.utils.device import const

ASK, BID = 0, 1
PRICE, QUANT, OID, TID, TS, TNS = range(6)
N_FIELDS = 6


@dataclass
class SideState:
    """Views of one side: each field is ``(E, S)`` int32."""

    price: torch.Tensor
    quant: torch.Tensor
    oid: torch.Tensor
    tid: torch.Tensor
    time_s: torch.Tensor
    time_ns: torch.Tensor

    @property
    def n(self) -> int:
        """The side's capacity ``S`` (ref: book.py:44-46)."""
        return self.price.shape[-1]

    @property
    def is_empty(self) -> torch.Tensor:
        """Holes, ``(E, S)`` bool (ref: book.py:48-50)."""
        return self.price == EMPTY_SLOT


@dataclass
class BookState:
    """Both sides of a batch of books, ``data`` is ``(E, 2, 6, S)`` int32."""

    data: torch.Tensor

    def side(self, i: int) -> SideState:
        d = self.data[:, i]
        return SideState(*(d[:, f] for f in range(N_FIELDS)))

    @property
    def asks(self) -> SideState:
        return self.side(ASK)

    @property
    def bids(self) -> SideState:
        return self.side(BID)


def init_book(cfg: EngineConfig, n_envs: int,
              device: Optional[torch.device] = None) -> BookState:
    """All-empty books (ref: JaxOrderBookArrays.py:901-911)."""
    return BookState(torch.full((n_envs, 2, N_FIELDS, cfg.n_orders),
                                EMPTY_SLOT, dtype=torch.int32, device=device))


def init_trades(cfg: EngineConfig, n_envs: int, device: torch.device
                ) -> torch.Tensor:
    """Empty ``(E, n_trades, 8)`` trade logs: every row -1
    (ref: ``vit_marl_tpu/lob/book.py::init_trades``)."""
    return torch.full((n_envs, cfg.n_trades, 8), EMPTY_SLOT,
                      dtype=torch.int32, device=device)


def init_side(n_orders: int, n_envs: int,
              device: Optional[torch.device] = None) -> SideState:
    """All-empty sides, fields ``(E, S)``
    (ref: JaxOrderBookArrays.py:901-911)."""
    empty = torch.full((n_envs, n_orders), EMPTY_SLOT, dtype=torch.int32,
                       device=device)
    return SideState(*(empty.clone() for _ in range(N_FIELDS)))


def book_from_sides(asks: SideState, bids: SideState) -> BookState:
    """The ``(E, 2, 6, S)`` book of two sides."""
    side = lambda s: torch.stack(  # noqa: E731
        [s.price, s.quant, s.oid, s.tid, s.time_s, s.time_ns], dim=1)
    return BookState(torch.stack([side(asks), side(bids)], dim=1)
                     .to(torch.int32))


# --------------------------------------------------------------------------
# Dense <-> field views (reference layout: (S, 6) [p, q, oid, tid, s, ns])
# --------------------------------------------------------------------------


def side_to_dense(side: SideState) -> torch.Tensor:
    """``(E, S, 6)`` int32 rows of the reference layout."""
    return torch.stack([side.price, side.quant, side.oid, side.tid,
                        side.time_s, side.time_ns], dim=-1).to(torch.int32)


def side_from_dense(dense: torch.Tensor) -> SideState:
    """Views of ``(E, S, 6)`` reference-layout rows."""
    dense = dense.to(torch.int32)
    return SideState(*(dense[..., f] for f in range(N_FIELDS)))


# --------------------------------------------------------------------------
# Canonical layout
# --------------------------------------------------------------------------


def sort_side(side: SideState, is_bid: bool) -> SideState:
    """Each env's side in the sorted-arena layout: occupied slots first in
    price-time priority (ascending price for asks, descending for bids,
    then time_s, time_ns, then the original slot), every plane of the
    holes behind them ``EMPTY_SLOT`` (ref: ``vit_marl_tpu/lob/book.py::
    sort_side``, a stable 5-key ``lax.sort``).

    Stable sorts from the least significant key to the most give the same
    order; the keys are not packed into one integer, whose products of
    price and time would overflow."""
    inel = (side.price == EMPTY_SLOT).to(torch.int32)
    price_key = -side.price if is_bid else side.price
    E, S = side.price.shape
    perm = torch.arange(S, device=side.price.device).expand(E, S)
    for key in (side.time_ns, side.time_s, price_key, inel):
        order = torch.sort(torch.gather(key, 1, perm), dim=1,
                           stable=True).indices
        perm = torch.gather(perm, 1, order)
    hole = torch.gather(inel, 1, perm) == 1
    return SideState(*(torch.where(hole, EMPTY_SLOT, torch.gather(v, 1, perm))
                       for v in _fields(side)))


def canonicalize_book(book: BookState) -> BookState:
    """:func:`sort_side` on both sides of every env's book."""
    return book_from_sides(sort_side(book.asks, is_bid=False),
                           sort_side(book.bids, is_bid=True))


def _prev_occupied(v: torch.Tensor, occ: torch.Tensor, first
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E, S)`` value of ``v`` at the last occupied slot before each slot
    (``first`` where there is none), and whether there is one."""
    E, S = v.shape
    slot = torch.arange(S, device=v.device).expand(E, S)
    last_occ = torch.where(occ, slot, -1).cummax(dim=1).values
    prev_idx = torch.cat([torch.full((E, 1), -1, device=v.device,
                                     dtype=last_occ.dtype),
                          last_occ[:, :-1]], dim=1)
    prev_o = prev_idx >= 0
    prev_v = torch.where(prev_o, torch.gather(v, 1, prev_idx.clamp(min=0)),
                         first)
    return prev_v, prev_o


def is_sorted_arena(side: SideState, is_bid: bool) -> torch.Tensor:
    """``(E,)`` bool: the occupied slots' prices are in priority order
    (non-decreasing for asks, non-increasing for bids), the precondition
    of :func:`_side_levels` and of the engine (ref: ``vit_marl_tpu/lob/
    book.py::is_sorted_arena``; time keys are not checked)."""
    occ = side.price != EMPTY_SLOT
    key = -side.price if is_bid else side.price
    prev_k, prev_o = _prev_occupied(key, occ, torch.iinfo(torch.int32).min)
    return (~occ | ~prev_o | (key >= prev_k)).all(dim=1)


# --------------------------------------------------------------------------
# Queries
# --------------------------------------------------------------------------


def _fields(side: SideState):
    return (side.price, side.quant, side.oid, side.tid, side.time_s,
            side.time_ns)


def _col(v, like: torch.Tensor) -> torch.Tensor:
    """A number or an ``(E,)`` tensor as an int32 column against the
    ``(E, S)`` fields of ``like``."""
    v = torch.as_tensor(v, dtype=torch.int32, device=like.device)
    return v.reshape(-1, 1) if v.dim() else v


def best_ask(cfg: EngineConfig, asks: SideState) -> torch.Tensor:
    """``(E,)`` lowest ask price, -1 where there is no ask
    (ref: JaxOrderBookArrays.py:846-855)."""
    lo = torch.where(asks.price == EMPTY_SLOT, cfg.maxint, asks.price
                     ).amin(dim=-1)
    return torch.where(lo == cfg.maxint, EMPTY_SLOT, lo)


def best_bid(cfg: EngineConfig, bids: SideState) -> torch.Tensor:
    """``(E,)`` highest bid price, -1 where there is no bid
    (ref: JaxOrderBookArrays.py:857-865)."""
    return bids.price.amax(dim=-1)


def best_bid_and_ask(cfg: EngineConfig, asks: SideState, bids: SideState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(best_ask, best_bid)``, each ``(E,)`` (ref: JaxOrderBookArrays.py:
    867-879)."""
    return best_ask(cfg, asks), best_bid(cfg, bids)


def volume_at_price(side: SideState, price) -> torch.Tensor:
    """``(E,)`` total standing quantity at ``price`` (a number or ``(E,)``),
    an int32 sum (ref: JaxOrderBookArrays.py:833-844)."""
    return torch.where(side.price == _col(price, side.price), side.quant,
                       0).sum(dim=-1, dtype=torch.int32)


def init_volume_at_price(cfg: EngineConfig, side: SideState, price
                         ) -> torch.Tensor:
    """``(E,)`` volume of initialisation orders (oid <= init_id) at
    ``price`` (ref: JaxOrderBookArrays.py:944-960)."""
    mask = (side.price == _col(price, side.price)) & (side.oid <= cfg.init_id)
    return torch.where(mask, side.quant, 0).sum(dim=-1, dtype=torch.int32)


def best_bid_and_ask_incl_quants(cfg: EngineConfig, book: BookState
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``((E, 2) [ask_p, ask_q], (E, 2) [bid_p, bid_q])`` int32
    (ref: JaxOrderBookArrays.py:881-898)."""
    asks, bids = book.asks, book.bids
    a, b = best_bid_and_ask(cfg, asks, bids)
    return (torch.stack([a, volume_at_price(asks, a)], dim=1).to(torch.int32),
            torch.stack([b, volume_at_price(bids, b)], dim=1).to(torch.int32))


def _side_levels(side: SideState, n_levels: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E, n_levels)`` level prices and volumes of the top levels.

    Relies on the sorted-arena invariant: distinct prices appear in
    priority order with same-price orders contiguous, so a level starts
    where an occupied slot's price differs from the previous occupied
    slot's.  Missing levels read price -1, volume 0.
    """
    price = side.price
    E, S = price.shape
    occ = price != EMPTY_SLOT
    prev_p, prev_o = _prev_occupied(price, occ, EMPTY_SLOT)
    is_new = occ & (~prev_o | (price != prev_p))
    lvl = torch.where(occ, is_new.to(torch.int32).cumsum(dim=1), 0)
    take = min(n_levels, S)
    lv = torch.arange(1, take + 1, device=price.device)[None, :, None]
    sel = lvl[:, None, :] == lv                                 # (E, L, S)
    prices = torch.where(sel, price[:, None, :], EMPTY_SLOT).amax(dim=2)
    vols = torch.where(sel, side.quant[:, None, :], 0).sum(
        dim=2, dtype=torch.int32)
    if take < n_levels:
        pad = n_levels - take
        prices = torch.cat([prices, prices.new_full((E, pad), EMPTY_SLOT)], 1)
        vols = torch.cat([vols, vols.new_zeros((E, pad))], 1)
    return prices.to(torch.int32), vols.clamp(min=0).to(torch.int32)


def get_l2_state(cfg: EngineConfig, n_levels: int, book: BookState
                 ) -> torch.Tensor:
    """``(E, 4*n_levels)`` [ask_p, ask_q, bid_p, bid_q] per level
    (ref: JaxOrderBookArrays.py:1075-1106)."""
    ap, av = _side_levels(book.asks, n_levels)
    bp, bv = _side_levels(book.bids, n_levels)
    return torch.stack([ap, av, bp, bv], dim=2).reshape(ap.shape[0], -1)


def get_vision_l2_state(cfg: EngineConfig, n_levels: int, book: BookState
                        ) -> torch.Tensor:
    """Raw book image ``(E, n_levels, 2, 2)`` int32: dim 2 is (price,
    volume), dim 3 is (ask, bid) (ref: ``vit_marl_tpu/lob/book.py::
    get_vision_l2_state``)."""
    ap, av = _side_levels(book.asks, n_levels)
    bp, bv = _side_levels(book.bids, n_levels)
    ask = torch.stack([ap, av], dim=2)                 # (E, L, 2)
    bid = torch.stack([bp, bv], dim=2)
    return torch.stack([ask, bid], dim=3).to(torch.int32)


def _rows_at(side: SideState, idx: torch.Tensor) -> torch.Tensor:
    """``(E, 6)`` rows of the slots ``idx`` ``(E,)``."""
    at = idx.long().reshape(-1, 1)
    return torch.stack([torch.gather(v, 1, at)[:, 0] for v in _fields(side)],
                       dim=1).to(torch.int32)


def _lookup(side: SideState, mask: torch.Tensor, not_found_val: int
            ) -> torch.Tensor:
    """``(E, 6)`` row of each env's first slot in ``mask``, else a row of
    ``not_found_val``."""
    row = _rows_at(side, mask.to(torch.int8).argmax(dim=1))
    return torch.where(mask.any(dim=1, keepdim=True), row, not_found_val
                       ).to(torch.int32)


def get_order_by_id(side: SideState, order_id) -> torch.Tensor:
    """First order row matching the order id, a -1 row where none does
    (ref: JaxOrderBookArrays.py:962-985)."""
    return _lookup(side, side.oid == _col(order_id, side.oid), -1)


def get_order_by_id_and_price(side: SideState, order_id, price
                              ) -> torch.Tensor:
    """(ref: JaxOrderBookArrays.py:987-1012)."""
    return _lookup(side, (side.oid == _col(order_id, side.oid))
                   & (side.price == _col(price, side.price)), -1)


def get_order_by_time(side: SideState, time_s, time_ns) -> torch.Tensor:
    """A -2 row where no order has the time, the reference's sentinel
    (ref: JaxOrderBookArrays.py:1015-1042)."""
    return _lookup(side, (side.time_s == _col(time_s, side.time_s))
                   & (side.time_ns == _col(time_ns, side.time_ns)), -2)


def get_order_ids(side: SideState) -> torch.Tensor:
    """``(E, S)`` each env's distinct order ids in ascending order, padded
    with 1 (ref: JaxOrderBookArrays.py:1044-1053, ``jnp.unique(size=S,
    fill_value=1)``; an empty slot's -1 counts as an id)."""
    v = torch.sort(side.oid, dim=1).values
    E, S = v.shape
    first = torch.ones_like(v, dtype=torch.bool)
    first[:, 1:] = v[:, 1:] != v[:, :-1]
    rank = first.to(torch.int32).cumsum(dim=1) - 1
    out = torch.ones((E, S + 1), dtype=torch.int32, device=v.device)
    out.scatter_(1, torch.where(first, rank, S).long(), v)
    return out[:, :S]


def top_order_index(cfg: EngineConfig, side: SideState, is_bid: bool
                    ) -> torch.Tensor:
    """``(E,)`` slot of the price-time-priority top order
    (ref: JaxOrderBookArrays.py:240-267): best price (max for bids, min
    over occupied slots for asks), then earliest (time_s, time_ns), then
    the lowest slot."""
    if is_bid:
        price_key = -side.price
    else:
        price_key = torch.where(side.price == EMPTY_SLOT, cfg.maxint,
                                side.price)
    best_p = price_key.amin(dim=1, keepdim=True)
    t = torch.where(price_key == best_p, side.time_s, cfg.maxint)
    best_t = t.amin(dim=1, keepdim=True)
    tns = torch.where(t == best_t, side.time_ns, cfg.maxint)
    best_tns = tns.amin(dim=1, keepdim=True)
    return (tns == best_tns).to(torch.int8).argmax(dim=1)


def get_next_executable_order(cfg: EngineConfig, side_idx: int,
                              side: SideState) -> torch.Tensor:
    """``(E, 6)`` top order row; ``side_idx`` 0 for asks, 1 for bids
    (ref: JaxOrderBookArrays.py:1055-1073)."""
    return _rows_at(side, top_order_index(cfg, side, is_bid=side_idx == 1))


def get_agent_trades(trades: torch.Tensor, agent_id) -> torch.Tensor:
    """``(E, n_trades, 8)`` trade logs with every row zeroed that is no
    executed trade of ``agent_id`` (a number or ``(E,)``) as passive or
    aggressive trader (ref: JaxOrderBookArrays.py:824-831)."""
    executed = torch.where(trades[..., TradeCol.PRICE:TradeCol.PRICE + 1]
                           >= 0, trades, 0)
    aid = _col(agent_id, trades[..., 0])
    mask = ((executed[..., TradeCol.PASS_TID] == aid)
            | (executed[..., TradeCol.AGR_TID] == aid))
    return torch.where(mask[..., None], executed, 0).to(torch.int32)


def init_msgs_from_l2(cfg: EngineConfig, book_l2: torch.Tensor,
                      time: torch.Tensor) -> torch.Tensor:
    """Limit-order messages reconstructing L2 snapshots
    (ref: JaxOrderBookArrays.py:913-942).

    ``book_l2`` is ``(W, 4*levels)`` LOBSTER rows [ask_p, ask_q, bid_p,
    bid_q] per level and ``time`` is ``(W, 2)``; returns ``(W, 2*levels,
    8)`` int32.  Init orders get oid ``cfg.init_id`` and descending trader
    ids.
    """
    W = book_l2.shape[0]
    n_rows = book_l2.shape[1] // 2
    data = book_l2.reshape(W, n_rows, 2).to(torch.int32)
    msgs = torch.zeros((W, n_rows, 8), dtype=torch.int32,
                       device=book_l2.device)
    msgs[:, :, MsgCol.PRICE] = data[:, :, 0]
    msgs[:, :, MsgCol.QUANT] = data[:, :, 1]
    msgs[:, :, MsgCol.TYPE] = 1
    msgs[:, 0::2, MsgCol.SIDE] = -1   # even rows: asks
    msgs[:, 1::2, MsgCol.SIDE] = 1    # odd rows: bids
    msgs[:, :, MsgCol.OID] = cfg.init_id
    msgs[:, :, MsgCol.TID] = cfg.init_id - torch.arange(
        n_rows, dtype=torch.int32, device=book_l2.device)
    msgs[:, :, MsgCol.TIME_S] = time[:, 0:1].to(torch.int32)
    msgs[:, :, MsgCol.TIME_NS] = time[:, 1:2].to(torch.int32)
    return msgs


def make_cancel_msgs(side: SideState, agent_id: torch.Tensor, size: int,
                     side_sign, time_s: torch.Tensor, time_ns: torch.Tensor
                     ) -> torch.Tensor:
    """Cancels for all standing orders of each agent, fixed size
    (ref: JaxOrderBookArrays.py:756-782).

    ``side`` fields are ``(E, S)``, ``agent_id`` is ``(E, n)`` (one id per
    agent instance), ``side_sign`` an int or ``(E, n)`` tensor, times
    ``(E,)``.  Returns ``(E, n, size, 8)`` int32.  Unmatched rows are
    zero-quantity, zero-price cancels, no-ops in the engine.
    """
    match = side.tid[:, None, :] == agent_id[:, :, None]          # (E, n, S)
    rank = match.to(torch.int32).cumsum(dim=2)
    k = torch.arange(1, size + 1, device=match.device)[:, None]
    sel = match[:, :, None, :] & (rank[:, :, None, :] == k)       # (E,n,k,S)

    def pick(v):
        return torch.where(sel, v[:, None, None, :], 0).sum(
            dim=3, dtype=torch.int32)

    E, n = agent_id.shape
    shape = (E, n, size)
    sign = const(side_sign, torch.int32, match.device)
    if sign.dim() == 2:
        sign = sign[:, :, None]
    msgs = torch.stack([
        torch.full(shape, 2, dtype=torch.int32, device=match.device),
        sign.expand(shape),
        pick(side.quant), pick(side.price), pick(side.oid), pick(side.tid),
        time_s[:, None, None].expand(shape),
        time_ns[:, None, None].expand(shape),
    ], dim=3)
    return msgs.to(torch.int32)
