"""Seeded book-scan inputs shared by the port's kernel tests and
``chip_smoke.py`` (numpy, and the port in :func:`engine_against_records`
and :func:`launch_slot_map`, so what runs on a card needs nothing of
JAX)."""

import functools

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


def add_sweeps(msgs, every=3, seed=0, fresh_ids=False):
    """Turn the first message of every ``every``-th env into a limit order
    that crosses the whole opposite side: one message with as many fills
    as that side holds orders (more than 16 at the usual fill).  With
    ``fresh_ids`` a sweep that carried order id -1 (a cancel of an empty
    slot) gets a fresh one: its remainder rests, and a live order of id -1
    is a corner on which the JAX package's engines differ
    (:func:`make_corner_case`)."""
    rng = np.random.default_rng(seed)
    msgs = msgs.copy()
    rows = np.arange(0, msgs.shape[0], every)
    side = rng.choice([-1, 1], rows.shape[0])
    msgs[rows, 0, 0] = 1
    msgs[rows, 0, 1] = side
    msgs[rows, 0, 2] = 10**6
    msgs[rows, 0, 3] = np.where(side == 1, 3_000_000, 1_000_000)
    if fresh_ids:
        msgs[rows, 0, 4] = np.where(msgs[rows, 0, 4] == -1, SWEEP_IDS + rows,
                                    msgs[rows, 0, 4])
    return msgs


MAX_INT32 = 2**31 - 1
INIT_ID = -2
# order ids no book or message of make_case carries, for ``fresh_ids``:
# limit orders that would rest with id -1 from FRESH_IDS, sweeps from
# SWEEP_IDS, stale order ids of holes from STALE_IDS on
FRESH_IDS, SWEEP_IDS, STALE_IDS = 10**6, 1_900_000, 2 * 10**6


def make_corner_case(E, M, S, seed, fill=0.6, tids=TIDS, shared=False,
                     fresh_ids=False):
    """``make_case`` with the corners of the scan's semantics added:

    - every env: holes whose other planes hold stale values; live orders
      with the INIT_ID order id -2 or with order id 0; a quarter of the
      messages of any (type, side) in {-1..6} x {-2..2} ({-1, 1} with
      ``shared``), unknown ones among them (they dispatch to index 0, a
      limit order) and (0, 0) padding; envs 2, 10, 18, ...: the last live
      ask at price 2^31 - 1 (the ask side's empty marker in the best quote);
    - unless ``shared``: some messages of quantity 0 or below; envs 0, 4,
      8, ...: live slots of quantity 0 or below; envs 1, 5, 9, ...:
      quantities of 2^29 to 2^31 - 1 on half the live slots and on a third
      of the messages, so prefix sums of crossing quantities wrap int32
      and a message that is no limit order can fill; envs 3, 7, 11, ...:
      positive quantities whose sum is short of 2^31 until a cancel of
      negative quantity lifts it past (``plant_negative_cancel``, the bid
      side in envs 3, 11, ..., the ask side in envs 7, 15, ...).

    With ``shared`` the case keeps to the corners on which the JAX package's
    two engines, its Pallas kernel and its XLA scan
    (``vit_marl_tpu/lob/engine.py``) with the trade summary of its log,
    agree (the XLA scan leaves stale planes in holes, which the kernel
    wipes), but for two corners of order ids that grow likelier with the
    number of envs; the others follow the Pallas kernel. The XLA scan's
    cancel takes the first slot whose order-id plane holds the id, a
    hole's too, and the kernel the first live one: so a cancel of a live
    order whose id a hole before it holds (a stale id, or -1 on a limit
    order that an odd type made of a cancel of an empty slot) differs
    (``tests/test_torch_engine.py::test_engines_differ_on_order_id_corners``).
    With ``shared`` and ``fresh_ids`` those corners are kept out too: a
    hole's stale order id is one no order carries (from STALE_IDS on), and
    a limit order of id -1 takes a fresh id. A side other than +-1 signs a
    fill's quantity in the log as ``-side * quant`` but not in the kernel's
    sums. Envs without those corners keep positive quantities that sum far
    below 2^31."""
    rng = np.random.default_rng(seed + 1000)
    book, msgs, prev = make_case(E, M, S, seed, fill=fill, tids=tids)
    book, msgs = book.astype(np.int64), msgs.astype(np.int64)
    env = np.arange(E)
    live = book[:, :, 0, :] != -1                          # (E, 2, S)
    shape = (E, 2, S)
    for f in range(1, 6):
        stale = (~live) & (rng.random(shape) < 0.7)
        book[:, :, f, :] = np.where(stale, rng.integers(-5, 10**6, shape),
                                    book[:, :, f, :])
    r = rng.random(shape)
    book[:, :, 2, :] = np.where(live & (r < 0.15), INIT_ID,
                                np.where(live & (r > 0.93), 0,
                                         book[:, :, 2, :]))
    for e in env[env % 8 == 2]:
        asks = np.flatnonzero(live[e, 0])
        if asks.size:
            book[e, 0, 0, asks[-1]] = MAX_INT32
    odd = rng.random((E, M)) < 0.25
    msgs[..., 0] = np.where(odd, rng.integers(-1, 7, (E, M)), msgs[..., 0])
    sides = rng.choice([-1, 1], (E, M)) if shared else rng.integers(
        -2, 3, (E, M))
    msgs[..., 1] = np.where(odd, sides, msgs[..., 1])
    if shared and fresh_ids:
        oid = book[:, :, 2, :]
        book[:, :, 2, :] = np.where(~live & (oid != -1), STALE_IDS + oid + 5,
                                    oid)
        fresh = (dispatch_index(msgs) <= 1) & (msgs[..., 4] == -1)
        msgs[..., 4] = np.where(fresh, FRESH_IDS + np.arange(E * M).reshape(
            E, M), msgs[..., 4])
    elif not shared:
        low = (env % 4 == 0)[:, None, None] & live & (rng.random(shape) < .2)
        book[:, :, 1, :] = np.where(low, rng.integers(-300, 1, shape),
                                    book[:, :, 1, :])
        wrap = (env % 4 == 1)[:, None, None] & live & (rng.random(shape) < .5)
        book[:, :, 1, :] = np.where(
            wrap, rng.integers(2**29, MAX_INT32, shape), book[:, :, 1, :])
        big = (env % 4 == 1)[:, None] & (rng.random((E, M)) < 0.3)
        msgs[..., 2] = np.where(big, rng.integers(2**30, MAX_INT32, (E, M)),
                                msgs[..., 2])
        small = rng.random((E, M)) < 0.05
        msgs[..., 2] = np.where(small, rng.integers(-50, 1, (E, M)),
                                msgs[..., 2])
        for e in env[env % 4 == 3]:
            plant_negative_cancel(book, msgs, e, 1 if e % 8 == 3 else 0)
    return book.astype(np.int32), msgs.astype(np.int32), prev


def full_negative_bids(book, msgs, seed):
    """Every env's bid side full (no hole) at prices of -200 and below, and
    a share of the messages priced to reach it: bids at negative prices
    (the full side drops its worst order) and sells that cross them.  The
    bid side's best price is below -1 until a fill or a cancel opens a
    hole, whose -1 then counts as the highest: the corner where a slot
    past the capacity must not read as a hole."""
    rng = np.random.default_rng(seed + 2000)
    book, msgs = book.copy(), msgs.copy()
    E, M = msgs.shape[:2]
    S = book.shape[-1]
    book[:, 1, 0] = -200 - TICK * np.arange(S)
    book[:, 1, 1] = rng.integers(1, 50, (E, S))
    book[:, 1, 2] = book[:, 1, 3] = 70_000 + np.arange(S)
    book[:, 1, 4] = 34_200
    book[:, 1, 5] = np.arange(S)
    bid = msgs[..., 1] == 1
    msgs[..., 3] = np.where(bid, -200 - TICK * rng.integers(0, S + 5, (E, M)),
                            msgs[..., 3])
    sell = (msgs[..., 1] == -1) & (rng.random((E, M)) < 0.2)
    msgs[..., 3] = np.where(sell, -TICK * rng.integers(2, S + 2, (E, M)),
                            msgs[..., 3])
    return book, msgs


def plant_negative_cancel(book, msgs, e, x, at=0):
    """Env ``e``: side ``x`` (0 ask, 1 bid) of the book gets live
    quantities that sum to 2^31 - 2^20, the second live slot holding most
    of it; message ``at`` cancels -2^30 from the first live slot (by a
    unique order id), which lifts that side's crossing prefix sums past
    2^31; message ``at + 1`` is a cancel on the other side priced to cross
    every slot of side ``x``, so the wrapped prefix sums make it fill the
    slots behind the second.  Needs three live slots on side ``x`` and
    ``at + 2 <= M``; does nothing otherwise."""
    slots = np.flatnonzero(book[e, x, 0] != -1)
    if slots.size < 3 or at + 2 > msgs.shape[1]:
        return
    q = book[e, x, 1]
    q[slots] = np.maximum(q[slots], 1)
    rest = int(q[slots].sum() - q[slots[1]])
    q[slots[1]] = 2**31 - 2**20 - rest
    oid = 900_000_000 + e
    book[e, x, 2, slots[0]] = oid
    side = 1 if x == 1 else -1        # the side a cancel of side x names
    msgs[e, at] = (2, side, -2**30, book[e, x, 0, slots[0]], oid,
                   oid, 34_300 + at, 0)
    msgs[e, at + 1] = (2, -side, 1, 1 if x == 1 else MAX_INT32 - 1,
                       123_456_789, 123_456_789, 34_301 + at, 0)


def dispatch_index(msgs):
    """(E, M) dispatch index of each message (0 sell limit or unknown, 1
    buy limit, 2 / 3 cancel on the ask / bid side, 4 padding), as the
    scan's (type, side) dispatch gives it."""
    t, s = msgs[..., 0], msgs[..., 1]
    return np.select([((s == 1) & (t == 1)) | ((s == -1) & (t == 4)),
                      (s == -1) & ((t == 2) | (t == 3)),
                      (s == 1) & ((t == 2) | (t == 3)),
                      (s == 0) & (t == 0)], [1, 2, 3, 4], 0)


def make_l2_rows(E, seed, levels=10, mid=2_200_000):
    """(E, 4 * levels) int32 LOBSTER order-book rows [ask_p, ask_q, bid_p,
    bid_q] per level around ``mid``, the levels a tick or two apart."""
    rng = np.random.default_rng(seed)
    ask = mid + TICK * np.cumsum(rng.integers(1, 3, (E, levels)), axis=1)
    bid = mid - TICK * np.cumsum(rng.integers(1, 3, (E, levels)), axis=1)
    q = rng.integers(1, 400, (E, levels, 2))
    return np.stack([ask, q[..., 0], bid, q[..., 1]], 2).reshape(
        E, -1).astype(np.int32)


def engine_against_records(cfg, msgs, book, prev, uniforms=None,
                           n_trades=2048):
    """The port's engine (``lob/engine.py``) and the book scan in records
    mode with ``rec_k = S`` (kernel 2 on CUDA tensors, its plain version on
    CPU ones) followed by ``finalize_trade_log_from_records``, on one case
    given as tensors: the books with the engine's holes wiped in every
    plane, the best quotes (the engine's forward-filled from ``prev``) and
    the ``(E, n_trades, 8)`` trade logs must be equal.  Holds on the
    corners both JAX engines share (``make_corner_case(..., shared=True,
    fresh_ids=True)``);
    raises ``AssertionError`` where they differ, else returns the number of
    fills logged and the most of one env."""
    import torch

    from vit_marl_tpu_torch.env.common import ffill_best_prices
    from vit_marl_tpu_torch.lob import engine
    from vit_marl_tpu_torch.ops import book_kernel as bkern

    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    empty = torch.full((E, n_trades, 8), -1, dtype=torch.int32,
                       device=msgs.device)
    eb, elog, (ea, ebb) = engine.process_messages_save_bidask(
        cfg, msgs, book, empty, M, uniforms)
    kb, (ka, kbb), (rec, counts) = bkern.process_step_records(
        cfg, msgs, book, prev, S, uniforms)
    klog = bkern.finalize_trade_log_from_records(empty, rec, msgs, counts)
    wiped = torch.where(eb.data[:, :, :1] == -1, -1, eb.data)
    checks = {"book": (wiped, kb.data),
              "best asks": (ffill_best_prices(ea, prev[:, 0]), ka),
              "best bids": (ffill_best_prices(ebb, prev[:, 1]), kbb),
              "trade log": (elog, klog)}
    for what, (want, got) in checks.items():
        if not torch.equal(want, got):
            raise AssertionError(f"engine and records scan differ: {what}")
    n = (elog[..., 0] != -1).sum(dim=1)
    if int(n.max()) >= n_trades:
        raise AssertionError("the trade log overflowed: raise n_trades")
    return int(n.sum()), int(n.max())


@functools.lru_cache(maxsize=None)
def _slot_map_plan(lib, S, spl, masked, n_agg, rec_k, device):
    """The launch plan of ``lib`` for a slot map, once per device (as the
    wrappers' ``launch_plan``, so a timed launch asks the runtime for
    nothing)."""
    from vit_marl_tpu_torch.ops import book_kernel as bkern

    return bkern._plan(lib, S, spl, masked, n_agg, rec_k)


def launch_slot_map(lib, cfg, msgs, book, prev, spl, masked, tids=None,
                    tick=TICK, rec_k=1, uniforms=None):
    """One launch of a book-scan library ``lib`` (``ctypes``, the C
    interface of ``book_scan.cu``) on a slot map of the caller's choosing
    (``spl`` slots a lane, ``masked`` or not; ``spl`` 0,
    ``book_kernel.BLOCK_ROUTE``, the block route at any capacity), which
    the wrappers never take: the masked map at an exact capacity times
    what the masks cost, the block route at 1,024 against the warp's.
    Kernel 1 with ``tids``, else kernel 2 at ``rec_k``; counts no launch.
    Returns the wrappers' ``(book, (asks, bids), (sums or records, totals
    or counts))``."""
    import torch

    from vit_marl_tpu_torch.ops import book_kernel as bkern

    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    dev = msgs.device
    msgs, book_in, prev, uniforms, u_ptr = bkern._kernel_inputs(
        cfg, msgs, book, prev, uniforms)
    n_agg = None if tids is None else tids.shape[0]
    book_out = torch.empty_like(book_in)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    common = (E, M, S, spl, int(masked))
    with torch.cuda.device(dev):
        smem = _slot_map_plan(lib, S, spl, masked, n_agg, rec_k,
                              dev)["dynamic_smem"]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tids is None:
            out = (torch.empty((E, M, rec_k, bkern.N_REC_PLANES),
                               dtype=torch.int32, device=dev),
                   torch.empty((E, M), dtype=torch.int32, device=dev))
            err = lib.book_scan_records(
                msgs.data_ptr(), book_in.data_ptr(), prev.data_ptr(), u_ptr,
                book_out.data_ptr(), bidask.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), *common, rec_k, int(cfg.cancel_mode),
                int(cfg.init_id), int(cfg.maxint), smem, stream)
        else:
            tids = tids.to(device=dev, dtype=torch.int32).contiguous()
            aggs = torch.empty((E, bkern.AGG_STATS * n_agg + bkern.AGG_TOTALS),
                               dtype=torch.int32, device=dev)
            err = lib.book_scan_aggs(
                msgs.data_ptr(), book_in.data_ptr(), prev.data_ptr(),
                tids.data_ptr(), u_ptr, book_out.data_ptr(),
                bidask.data_ptr(), aggs.data_ptr(), *common, n_agg,
                int(cfg.cancel_mode), int(cfg.init_id), int(tick),
                int(cfg.maxint), smem, stream)
            out = (aggs[:, :bkern.AGG_STATS * n_agg].reshape(
                E, n_agg, bkern.AGG_STATS), aggs[:, bkern.AGG_STATS * n_agg:])
    bkern._raise_on(err, lib, "book_scan_" + ("records" if tids is None
                                              else "aggs"))
    return (bkern.BookState(book_out), (bidask[:, :, 0:2], bidask[:, :, 2:4]),
            out)
