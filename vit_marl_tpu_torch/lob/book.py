"""Order-book state for a batch of environments, and its queries.

Port of the main-path parts of ``vit_marl_tpu/lob/book.py``.  The JAX
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

from vit_marl_tpu_torch.config import EMPTY_SLOT, EngineConfig, MsgCol
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


def best_bid_and_ask_incl_quants(cfg: EngineConfig, book: BookState
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``((E, 2) [ask_p, ask_q], (E, 2) [bid_p, bid_q])`` int32
    (ref: JaxOrderBookArrays.py:881-898)."""
    asks, bids = book.asks, book.bids
    lo = torch.where(asks.price == EMPTY_SLOT, cfg.maxint, asks.price
                     ).amin(dim=-1)
    a = torch.where(lo == cfg.maxint, EMPTY_SLOT, lo)
    b = bids.price.amax(dim=-1)
    a_q = torch.where(asks.price == a[:, None], asks.quant, 0).sum(
        dim=-1, dtype=torch.int32)
    b_q = torch.where(bids.price == b[:, None], bids.quant, 0).sum(
        dim=-1, dtype=torch.int32)
    return (torch.stack([a, a_q], dim=1).to(torch.int32),
            torch.stack([b, b_q], dim=1).to(torch.int32))


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
    # previous occupied price (exclusive forward fill along the slots)
    slot = torch.arange(S, device=price.device).expand(E, S)
    last_occ = torch.where(occ, slot, -1).cummax(dim=1).values
    prev_idx = torch.cat([torch.full((E, 1), -1, device=price.device,
                                     dtype=last_occ.dtype),
                          last_occ[:, :-1]], dim=1)
    prev_o = prev_idx >= 0
    prev_p = torch.gather(price, 1, prev_idx.clamp(min=0))
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
