"""Slow sequential numpy oracle of the sorted-book engine semantics.

The port's copy of ``vit_marl_tpu/lob/oracle.py`` on the port's config
(numpy only).  Used by the tests to hold the batched engine in
:mod:`vit_marl_tpu_torch.lob.engine` against an independent sequential
model.  Implements, order by order, the
behaviour documented there (which matches the reference engine,
ref: gymnax_exchange/jaxob/JaxOrderBookArrays.py, modulo the three
documented slot-layout divergences):

- each side is a list of orders kept sorted by price-time priority
  (ascending price for asks / descending for bids, then time_s, time_ns,
  then arrival order);
- limit orders fill against the crossing prefix of the opposite side, one
  trade row per matched order, remainder rests at its priority position;
  a full side drops the worst order to admit the new one;
- trade rows ``[p, -side*q, pass_oid, agr_oid, t_s, t_ns, pass_tid,
  agr_tid]`` append at the running count; on overflow the final slot keeps
  the last-matched trade;
- cancels: strict-oid -> init-order-at-price (enough quantity) fallback;
  a complete miss is a no-op;
- MATCH(4) messages act as opposite-side limits, DELETE(3) as CANCEL(2).

Deterministic cancel modes (STRICT_BY_ID, INCLUDE_INITS) are modelled;
CANCEL_UNIFORM's random stage is covered by statistical tests instead.

Plain Python lists and loops — clarity over speed.
"""

from __future__ import annotations

import numpy as np

from vit_marl_tpu_torch.config import CancelMode, EngineConfig

EMPTY = -1


class OracleBook:
    """Sequential sorted order book; dense views match the engine layout."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.asks: list = []   # each order: [price, quant, oid, tid, ts, tns]
        self.bids: list = []
        self.trades = np.full((cfg.n_trades, 8), EMPTY, dtype=np.int64)
        self.trade_count = 0

    # -- layout ----------------------------------------------------------

    def load_dense(self, asks: np.ndarray, bids: np.ndarray,
                   trades: np.ndarray) -> None:
        """Ingest reference-layout arrays (sorted on entry, like the
        engine's ``sort_side`` canonicalisation)."""
        def rows(arr, is_bid):
            occ = [list(map(int, r)) for r in arr if r[0] != EMPTY]
            sign = -1 if is_bid else 1
            occ.sort(key=lambda r: (sign * r[0], r[4], r[5]))
            return occ
        self.asks = rows(asks, False)
        self.bids = rows(bids, True)
        self.trades[:] = trades
        self.trade_count = int((trades[:, 0] != EMPTY).sum())

    def dense(self, side) -> np.ndarray:
        arr = np.full((self.cfg.n_orders, 6), EMPTY, dtype=np.int64)
        for i, row in enumerate(side):
            arr[i] = row
        return arr

    # -- helpers ---------------------------------------------------------

    def _add_trade_batch(self, rows) -> None:
        """Append rows at trade_count with overflow-last-wins semantics."""
        cap = self.cfg.n_trades
        n_new = len(rows)
        overflow = self.trade_count + n_new > cap
        for i, row in enumerate(rows):
            target = self.trade_count + i
            last = i == n_new - 1
            if overflow:
                if target < cap - 1:
                    self.trades[target] = row
                elif last:
                    self.trades[cap - 1] = row
            elif target < cap:
                self.trades[target] = row
        self.trade_count = min(self.trade_count + n_new, cap)

    def _insert(self, side, is_bid, order) -> None:
        if order[1] <= 0:
            return
        sign = -1 if is_bid else 1
        key = (sign * order[0], order[4], order[5])
        pos = 0
        for r in side:
            if (sign * r[0], r[4], r[5]) <= key:
                pos += 1
            else:
                break
        if len(side) == self.cfg.n_orders:
            side.pop()                     # drop worst on overflow
            pos = min(pos, self.cfg.n_orders - 1)
        side.insert(pos, list(order))

    # -- operations ------------------------------------------------------

    def _limit(self, opp, same, opp_is_ask, price, quant, oid, tid, ts, tns,
               raw_side) -> None:
        qtm = quant
        trades = []
        while qtm > 0 and opp:
            top = opp[0]
            crosses = top[0] <= price if opp_is_ask else top[0] >= price
            if not crosses:
                break
            fill = min(top[1], qtm)
            trades.append([top[0], -raw_side * fill, top[2], oid, ts, tns,
                           top[3], tid])
            top[1] -= fill
            qtm -= fill
            if top[1] <= 0:
                opp.pop(0)
        self._add_trade_batch(trades)
        # opp is the ask side <=> the remainder rests on the bid side
        self._insert(same, opp_is_ask, [price, qtm, oid, tid, ts, tns])

    def _cancel(self, side, price, quant, oid) -> None:
        idx = next((i for i, r in enumerate(side) if r[2] == oid), -1)
        if idx == -1 and self.cfg.cancel_mode >= CancelMode.INCLUDE_INITS:
            idx = next((i for i, r in enumerate(side)
                        if r[0] == price and r[2] <= self.cfg.init_id
                        and r[1] >= quant), -1)
        if idx == -1:
            return                          # miss -> no-op
        side[idx][1] -= quant
        if side[idx][1] <= 0:
            side.pop(idx)

    def process(self, msg) -> None:
        t, s, quant, price, oid, tid, ts, tns = [int(x) for x in msg]
        if (s == 0) and (t == 0):
            return
        if ((s == 1) and (t == 1)) or ((s == -1) and (t == 4)):
            self._limit(self.asks, self.bids, True, price, quant, oid, tid,
                        ts, tns, s)
        elif (s == -1) and (t in (2, 3)):
            self._cancel(self.asks, price, quant, oid)
        elif (s == 1) and (t in (2, 3)):
            self._cancel(self.bids, price, quant, oid)
        else:
            self._limit(self.bids, self.asks, False, price, quant, oid, tid,
                        ts, tns, s)

    def process_all(self, msgs) -> None:
        for m in np.asarray(msgs):
            self.process(m)
