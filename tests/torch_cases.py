"""Seeded book-scan inputs shared by the port's kernel tests and
``chip_smoke.py`` (numpy only, so what runs on a card needs nothing of
JAX)."""

import numpy as np

TIDS = (-42, -43)
TICK = 100


def make_case(E, M, S, seed, fill=0.6, tids=TIDS):
    """Sorted-arena books (E, 2, 6, S) and mixed streams (E, M, 8); a share
    of resting orders and messages belongs to the traders ``tids``."""
    rng = np.random.default_rng(seed)
    mid = 2_200_000
    occ = rng.random((E, 2, S)) < fill
    lvl = np.cumsum(rng.integers(0, 3, (E, 2, S)) * TICK * occ, axis=2)
    price = np.stack([mid + TICK + lvl[:, 0], mid - TICK - lvl[:, 1]], 1)
    ts = np.broadcast_to(34_200 + np.arange(S), (E, 2, S))
    tns = rng.integers(0, 10**9, (E, 2, S))
    quant = rng.integers(1, 300, (E, 2, S))
    oid = np.where(rng.random((E, 2, S)) < 0.3, -2,
                   10_000 + np.arange(2 * S).reshape(2, S))
    tid = np.where(rng.random((E, 2, S)) < 0.2,
                   rng.choice(tids, (E, 2, S)), oid)
    book = np.stack([price, quant, oid, tid, ts, tns], 2)
    book = np.where(occ[:, :, None, :], book, -1).astype(np.int32)

    kind = rng.choice(8, (E, M), p=[.3, .15, .15, .1, .1, .1, .05, .05])
    side = rng.choice([-1, 1], (E, M))
    j = rng.integers(0, S, (E, M))
    y = book[np.arange(E)[:, None], np.where(side == 1, 1, 0), :, j]
    off = rng.integers(1, 12, (E, M)) * TICK
    passive = np.where(side == 1, mid - off, mid + off)
    aggressive = np.where(side == 1, mid + off, mid - off)
    msgs = np.zeros((E, M, 8), np.int64)
    msgs[..., 0] = np.select([kind <= 1, kind <= 3, kind == 4, kind == 5,
                              kind == 7], [1, 2, 3, 4, 5], 0)
    msgs[..., 1] = side
    cancel_q = np.maximum(y[..., 1] // rng.integers(1, 3, (E, M)), 1)
    msgs[..., 2] = np.where((kind >= 2) & (kind <= 4), cancel_q,
                            rng.integers(1, 500, (E, M)))
    msgs[..., 3] = np.select([kind == 0, kind == 1, kind <= 4],
                             [passive, aggressive, y[..., 0]], aggressive)
    msgs[..., 4] = np.where((kind == 2) | (kind == 4), y[..., 2],
                            500_000 + np.arange(E * M).reshape(E, M))
    msgs[..., 5] = np.where(rng.random((E, M)) < 0.3,
                            rng.choice(tids, (E, M)), msgs[..., 4])
    msgs[..., 6] = 34_300 + np.arange(M)
    msgs[..., 7] = rng.integers(0, 10**9, (E, M))
    msgs[kind == 6] = 0
    prev = np.stack([np.full(E, mid + 700), np.full(E, mid - 700)], 1)
    return book, msgs.astype(np.int32), prev.astype(np.int32)


def add_sweeps(msgs, every=3, seed=0):
    """Turn the first message of every ``every``-th env into a limit order
    that crosses the whole opposite side: one message with as many fills
    as that side holds orders (more than 16 at the usual fill)."""
    rng = np.random.default_rng(seed)
    msgs = msgs.copy()
    rows = np.arange(0, msgs.shape[0], every)
    side = rng.choice([-1, 1], rows.shape[0])
    msgs[rows, 0, 0] = 1
    msgs[rows, 0, 1] = side
    msgs[rows, 0, 2] = 10**6
    msgs[rows, 0, 3] = np.where(side == 1, 3_000_000, 1_000_000)
    return msgs
