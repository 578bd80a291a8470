"""Randomized test fixtures: synthetic books and message streams.

The port's copy of ``vit_marl_tpu/utils/fixtures.py`` on the port's config
(numpy only); the same numpy generator state gives the same arrays.

Stand-ins for real LOBSTER data in unit/property tests
(ref: gymnax_exchange/utils/utils.py:117-299 provides the same capability
via ``create_init_book`` / ``create_rand_message`` / etc.).  All generation
is numpy-side (host), seeded, and returns reference-layout arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vit_marl_tpu_torch.config import EngineConfig, MsgCol


def random_book(
    cfg: EngineConfig,
    rng: np.random.Generator,
    mid_price: int = 2_200_000,
    tick: int = 100,
    n_levels: int = 20,
    percent_fill: float = 0.5,
    quant_range: Tuple[int, int] = (1, 500),
    time_init: Tuple[int, int] = (34_200, 0),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random plausible book: asks above mid, bids below, init-order ids
    (dense (n, 6) layout + empty trade log)."""
    n_fill = int(cfg.n_orders * percent_fill)
    asks = np.full((cfg.n_orders, 6), -1, dtype=np.int64)
    bids = np.full((cfg.n_orders, 6), -1, dtype=np.int64)
    oid = cfg.init_id
    for i in range(n_fill):
        ap = mid_price + tick * int(rng.integers(1, n_levels + 1))
        bp = mid_price - tick * int(rng.integers(1, n_levels + 1))
        aq = int(rng.integers(*quant_range))
        bq = int(rng.integers(*quant_range))
        asks[i] = [ap, aq, oid, oid, time_init[0], time_init[1]]
        bids[i] = [bp, bq, oid - 1, oid - 1, time_init[0], time_init[1]]
        oid -= 2
    trades = np.full((cfg.n_trades, 8), -1, dtype=np.int64)
    return asks, bids, trades


def random_message(
    rng: np.random.Generator,
    mid_price: int = 2_200_000,
    tick: int = 100,
    n_levels: int = 25,
    quant_range: Tuple[int, int] = (1, 300),
    time_s: int = 34_201,
    oid: int = -300,
    tid: int = -300,
    kind: Optional[str] = None,
) -> np.ndarray:
    """One random (8,) message near the mid price."""
    kind = kind or rng.choice(["limit", "limit", "limit", "cancel", "delete",
                               "match", "noop"])
    side = int(rng.choice([-1, 1]))
    price = mid_price + tick * int(rng.integers(-n_levels, n_levels + 1))
    quant = int(rng.integers(*quant_range))
    msg = np.zeros(8, dtype=np.int64)
    if kind == "noop":
        return msg
    msg[MsgCol.TYPE] = {"limit": 1, "cancel": 2, "delete": 3, "match": 4}[kind]
    msg[MsgCol.SIDE] = side
    msg[MsgCol.QUANT] = quant
    msg[MsgCol.PRICE] = price
    msg[MsgCol.OID] = oid
    msg[MsgCol.TID] = tid
    msg[MsgCol.TIME_S] = time_s
    msg[MsgCol.TIME_NS] = int(rng.integers(0, 1_000_000_000))
    return msg


def random_cancel_for_book(
    rng: np.random.Generator,
    side_arr: np.ndarray,
    side_sign: int,
    time_s: int = 34_202,
    partial: bool = True,
) -> np.ndarray:
    """A cancel message targeting a random standing order of ``side_arr``."""
    occupied = np.where(side_arr[:, 0] != -1)[0]
    msg = np.zeros(8, dtype=np.int64)
    msg[MsgCol.TYPE] = 2
    msg[MsgCol.SIDE] = side_sign
    msg[MsgCol.TIME_S] = time_s
    if len(occupied) == 0:
        return msg
    i = int(rng.choice(occupied))
    q = int(side_arr[i, 1])
    msg[MsgCol.QUANT] = int(rng.integers(1, q + 1)) if partial and q > 1 else q
    msg[MsgCol.PRICE] = int(side_arr[i, 0])
    msg[MsgCol.OID] = int(side_arr[i, 2])
    msg[MsgCol.TID] = int(side_arr[i, 3])
    return msg


def random_aggressive_message(
    rng: np.random.Generator,
    asks: np.ndarray,
    bids: np.ndarray,
    quant_range: Tuple[int, int] = (1, 2000),
    time_s: int = 34_203,
    oid: int = -400,
) -> np.ndarray:
    """A limit order guaranteed to cross the spread (forces matching)."""
    side = int(rng.choice([-1, 1]))
    if side == 1:  # aggressive bid: price above some standing ask
        prices = asks[asks[:, 0] != -1][:, 0]
        price = int(prices.max()) if len(prices) else 2_300_000
    else:          # aggressive ask: price below some standing bid
        prices = bids[bids[:, 0] != -1][:, 0]
        price = int(prices.min()) if len(prices) else 2_100_000
    msg = np.zeros(8, dtype=np.int64)
    msg[MsgCol.TYPE] = 1
    msg[MsgCol.SIDE] = side
    msg[MsgCol.QUANT] = int(rng.integers(*quant_range))
    msg[MsgCol.PRICE] = price
    msg[MsgCol.OID] = oid
    msg[MsgCol.TID] = oid
    msg[MsgCol.TIME_S] = time_s
    msg[MsgCol.TIME_NS] = int(rng.integers(0, 1_000_000_000))
    return msg
