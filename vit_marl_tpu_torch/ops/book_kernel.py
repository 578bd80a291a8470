"""Book scan: one step's messages against a batch of books.

Per env, the step's M messages run in order against the book: (type,
side) dispatch, the cancel fallback chain, matching by prefix sum over the
crossing slots, the hole-arena insert, and the forward-filled best
ask/bid after every message.  Two modes, as in the TPU kernel's body
``vit_marl_tpu/ops/book_kernel.py::_make_kernel``:

- aggregate mode (the training path; replaces ``pallas_process_step_aggs``):
  exact int32 per-trader trade sums in tick units, the ``TradeSummary``
  contract of ``env/common.py::summary_from_aggs``;
- records mode (the ``debug_mode`` path; replaces ``pallas_process_step``):
  each message's fills, rank-compacted in slot order, from which
  :func:`finalize_trade_log_from_records` builds the trade log.

Each mode has two implementations of one function:

- a plain PyTorch version on ``(E, S)`` tensors, a transcription of the
  Pallas kernel (:func:`process_step_aggs_reference`,
  :func:`process_step_records_reference`; one shared scan body);
- a CUDA kernel in ``csrc/book_scan.cu`` (one warp per env, a block of
  threads per env past 1,024 slots; its source
  note has the design and what bounds it).

:func:`process_step_aggs` and :func:`process_step_records` are the
wrappers the environment calls.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.  Each wrapper's ``launches``
counts its kernel's launches.

Book capacities.  Both implementations have the Pallas kernel's semantics
at every capacity ``S >= 1`` (``n_orders``).  The kernel's slot map comes
from :func:`capacity_route`: 32, 64, 128 and 256 take the exact kernels,
every other capacity to ``WARP_CAPACITY`` (1,024) a masked one whose
slots past ``S`` are never live, never a hole and never recorded, and
every capacity past it the block route (``BLOCK_ROUTE``: a block of 256
threads an env, the book in shared memory where it fits, else in device
memory).  The Pallas kernel takes
``S % 8 == 0``; at other capacities the JAX package runs its XLA scan,
which agrees with these semantics but for the order-id corners of
``tests/test_torch_engine.py::test_engines_differ_on_order_id_corners``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Tuple

import torch

from vit_marl_tpu_torch.config import CancelMode, EMPTY_SLOT, EngineConfig
from vit_marl_tpu_torch.lob.book import (
    ASK,
    BID,
    OID,
    PRICE,
    QUANT,
    TID,
    TNS,
    TS,
    BookState,
)
from vit_marl_tpu_torch.ops import nvcc, tally

AGG_STATS = 8    # buy_q, sell_q, buy_pqt, sell_pqt, a_q, a_pqt, dur, signed
AGG_TOTALS = 2   # total_q, total_pq_tick
REC_K = 16       # records per message the debug log keeps in modes 0 and 1
WARP_CAPACITY = 1024  # the largest book a warp holds (32 slots a lane)
EXACT_CAPACITIES = (32, 64, 128, 256)
BLOCK_ROUTE = 0     # capacity_route's slots a lane past WARP_CAPACITY
N_REC_PLANES = 4  # price, -side * matched quant, passive oid, passive tid
EMPTY_RECORD = (EMPTY_SLOT, 0, 0, 0)

SOURCE = os.path.join(nvcc.CSRC, "book_scan.cu")
BUILD_DIR = nvcc.BUILD_DIR


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------


def _first_idx(mask: torch.Tensor, default: int) -> torch.Tensor:
    """(E,) index of the first True along the slots, else ``default``."""
    S = mask.shape[-1]
    iota = torch.arange(S, device=mask.device, dtype=torch.int32)
    return torch.where(mask, iota, default).amin(dim=-1)


def _last_idx(mask: torch.Tensor, default: int) -> torch.Tensor:
    S = mask.shape[-1]
    iota = torch.arange(S, device=mask.device, dtype=torch.int32)
    return torch.where(mask, iota, default).amax(dim=-1)


def _isum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over the slots with int32 wraparound."""
    return x.sum(dim=-1, dtype=torch.int32)


def _scan_reference(cfg: EngineConfig, msgs: torch.Tensor, book: BookState,
                    prev_prices: torch.Tensor,
                    uniforms: Optional[torch.Tensor], on_fills):
    """The scan both plain versions share: every message of ``msgs`` in
    order against ``book``, as the Pallas kernel's body ``_make_kernel``
    runs it.  After matching message ``m`` it calls ``on_fills(m, s, tid,
    Xp, Xo, Xt, matched, was, total_matched)`` with the message's side and
    trader id ``(E,)``, the matched side's price, oid and tid planes and
    the matched quantities ``(E, S)``, ``was = matched > 0`` and their sum
    ``(E,)``.  Returns the canonical book and the ``(E, M, 4)`` best
    prices and quantities.

    Every integer result is bit-equal to the Pallas kernel: the arithmetic
    is int32 with wraparound, ``//`` is floor division, and the
    random-cancel CDF is compared in float32 as the kernel does.  Within
    the loop only the price plane marks a hole; the other planes of a hole
    may hold stale values until the canonicalisation after the loop, and
    every mask guards on occupancy.
    """
    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    dev = msgs.device
    include_inits = cfg.cancel_mode >= CancelMode.INCLUDE_INITS
    cancel_uniform = cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM
    cancel_large = cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM_AND_LARGE
    iota = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    rows = torch.arange(E, device=dev)

    bk = book.data.clone()                    # (E, 2, 6, S)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    prev_a = prev_prices[:, 0].to(torch.int32)
    prev_b = prev_prices[:, 1].to(torch.int32)

    for m in range(M):
        msg = msgs[:, m].to(torch.int32)
        t, s, quant, price = msg[:, 0], msg[:, 1], msg[:, 2], msg[:, 3]
        oid, tid, ts, tns = msg[:, 4], msg[:, 5], msg[:, 6], msg[:, 7]
        index = ((((s == -1) & (t == 1)) | ((s == 1) & (t == 4))).int() * 0
                 + (((s == 1) & (t == 1)) | ((s == -1) & (t == 4))).int() * 1
                 + (((s == -1) & (t == 2)) | ((s == -1) & (t == 3))).int() * 2
                 + (((s == 1) & (t == 2)) | ((s == 1) & (t == 3))).int() * 3
                 + ((s == 0) & (t == 0)).int() * 4)
        is_bid_lim = index == 1
        is_lim = (index == 0) | is_bid_lim
        is_bid_cancel = index == 3
        is_cancel = (index == 2) | is_bid_cancel
        bid_frame = is_bid_lim | is_bid_cancel            # (E,)
        x_side = torch.where(bid_frame, ASK, BID)
        y_side = 1 - x_side
        X = bk[rows, x_side]                               # (E, 6, S)
        Y = bk[rows, y_side]
        Xp, Xq, Xo, Xt = X[:, PRICE], X[:, QUANT], X[:, OID], X[:, TID]
        Yp, Yq, Yo = Y[:, PRICE], Y[:, QUANT], Y[:, OID]
        Ys, Yn = Y[:, TS], Y[:, TNS]
        col = lambda v: v[:, None]                          # noqa: E731

        # ---- cancel pass on Y (identity unless cancelling) ----
        c_quant = torch.where(is_cancel, quant, 0)
        c_oid = torch.where(is_cancel, oid, 0)
        occ_y0 = Yp != EMPTY_SLOT
        idx1 = _first_idx((Yo == col(c_oid)) & occ_y0, S)
        if include_inits:
            m2 = ((Yp == col(price)) & (Yo <= cfg.init_id)
                  & (Yq >= col(c_quant)) & occ_y0)
            cidx = torch.where(idx1 < S, idx1, _first_idx(m2, S))
        else:
            cidx = idx1
        if cancel_uniform:
            u_raw = uniforms[m].to(torch.float32)           # (E,)

            def _cdf_pick(cand):
                w = cand.to(torch.float32)
                total = w.sum(dim=-1)
                uu = u_raw * torch.clamp(total, min=1.0)
                cdf = cand.to(torch.int32).cumsum(dim=-1).to(torch.float32)
                hit = cdf > col(uu)
                pick = torch.where(hit.any(dim=-1), _first_idx(hit, S), 0)
                chosen = _isum(torch.where((iota == col(pick)) & cand, Yo, 0))
                idx = _first_idx((Yo == col(chosen)) & occ_y0, S)
                return torch.where(total > 0, idx, S)

            m3 = ((Yp == col(price)) & (Yq >= col(c_quant)) & occ_y0
                  & (Yo != 0))
            cidx = torch.where(cidx < S, cidx, _cdf_pick(m3))
            if cancel_large:
                m3b = (Yp == col(price)) & occ_y0 & (Yo != 0)
                cidx = torch.where(cidx < S, cidx, _cdf_pick(m3b))
        found = cidx < S
        at_pos = iota == col(cidx)
        q_at = _isum(torch.where(at_pos, Yq, 0))
        new_q = q_at - c_quant
        dec = col(found) & at_pos
        Yq = torch.where(dec, col(new_q), Yq)
        Yp = torch.where(dec & col(new_q <= 0), EMPTY_SLOT, Yp)

        # ---- limit pass: match against X ----
        lim_quant = torch.where(is_lim, quant, 0)
        occupied = Xp != EMPTY_SLOT
        crossing = occupied & ((col(bid_frame) & (Xp <= col(price)))
                               | (col(~bid_frame) & (Xp >= col(price))))
        q = torch.where(crossing, Xq, 0)
        cum = q.cumsum(dim=-1, dtype=torch.int32)
        matched = torch.where(
            crossing,
            torch.minimum(torch.clamp(col(lim_quant) - (cum - q), min=0), q),
            0)
        total_matched = _isum(matched)
        was = matched > 0

        on_fills(m, s, tid, Xp, Xo, Xt, matched, was, total_matched)

        Xq = Xq - matched
        Xp = torch.where(was & (Xq <= 0), EMPTY_SLOT, Xp)

        # ---- insert the remainder into Y (hole-arena sorted insert) ----
        add_q = torch.clamp(lim_quant - total_matched, min=0)
        do_ins = col(add_q > 0)
        occ_y = Yp != EMPTY_SLOT
        hole = ~occ_y
        bf = col(bid_frame)
        pk = torch.where(bf, -Yp, Yp)
        nk = col(torch.where(bid_frame, -price, price))
        before = occ_y & ((pk < nk) | ((pk == nk) & (
            (Ys < col(ts)) | ((Ys == col(ts)) & (Yn <= col(tns))))))
        worse = occ_y & ~before
        fw = col(_first_idx(worse, S))
        lb = col(_last_idx(before, -1))
        in_win = hole & (iota > lb) & (iota < fw)
        case_a = in_win.any(dim=-1, keepdim=True)
        pos_a = col(_first_idx(in_win, S))
        hole_after = hole & (iota >= fw)
        case_bh = hole_after.any(dim=-1, keepdim=True)
        ha = torch.where(case_bh, col(_first_idx(hole_after, S - 1)), S - 1)
        hole_before = hole & (iota <= lb)
        case_c = hole_before.any(dim=-1, keepdim=True)
        hb = col(_last_idx(hole_before, 0))
        use_b = ~case_a & (case_bh | ~case_c)
        fw_b = torch.where(case_bh, fw, torch.clamp(fw, max=S - 1))

        def place(x, val):
            out_a = torch.where(iota == pos_a, col(val), x)
            right = torch.roll(x, 1, dims=-1)
            out_b = torch.where((iota > fw_b) & (iota <= ha), right, x)
            out_b = torch.where(iota == fw_b, col(val), out_b)
            left = torch.roll(x, -1, dims=-1)
            out_c = torch.where((iota >= hb) & (iota < lb), left, x)
            out_c = torch.where(iota == lb, col(val), out_c)
            out = torch.where(case_a, out_a, torch.where(use_b, out_b, out_c))
            return torch.where(do_ins, out, x)

        Y_new = torch.stack([place(Yp, price), place(Yq, add_q),
                             place(Yo, oid), place(Y[:, TID], tid),
                             place(Ys, ts), place(Yn, tns)], dim=1)
        X_new = torch.stack([Xp, Xq, Xo, Xt, X[:, TS], X[:, TNS]], dim=1)
        bk[rows, x_side] = X_new
        bk[rows, y_side] = Y_new

        # ---- best bid/ask, forward-filled from the previous message ----
        ap, bp = bk[:, ASK, PRICE], bk[:, BID, PRICE]
        best_a = torch.where(ap == EMPTY_SLOT, cfg.maxint, ap).amin(dim=-1)
        best_a = torch.where(best_a == cfg.maxint, EMPTY_SLOT, best_a)
        best_b = bp.amax(dim=-1)
        a_q = _isum(torch.where(ap == col(best_a), bk[:, ASK, QUANT], 0))
        b_q = _isum(torch.where(bp == col(best_b), bk[:, BID, QUANT], 0))
        a_invalid = best_a == EMPTY_SLOT
        b_invalid = best_b == EMPTY_SLOT
        best_a = torch.where(a_invalid, prev_a, best_a)
        a_q = torch.where(a_invalid, 0, a_q)
        best_b = torch.where(b_invalid, prev_b, best_b)
        b_q = torch.where(b_invalid, 0, b_q)
        bidask[:, m] = torch.stack([best_a, a_q, best_b, b_q], dim=1)
        prev_a, prev_b = best_a, best_b

    # canonicalise: every plane of a hole reads EMPTY_SLOT
    hole = bk[:, :, PRICE:PRICE + 1] == EMPTY_SLOT          # (E, 2, 1, S)
    return BookState(torch.where(hole, EMPTY_SLOT, bk)), bidask


def process_step_aggs_reference(cfg: EngineConfig, msgs: torch.Tensor,
                                book: BookState, tids: torch.Tensor,
                                prev_prices: torch.Tensor, tick: int,
                                uniforms: Optional[torch.Tensor] = None):
    """Plain PyTorch book scan in aggregate mode; same arguments and
    results as :func:`process_step_aggs`, bit-equal to the Pallas kernel
    (see :func:`_scan_reference`)."""
    E = msgs.shape[0]
    n_agg = tids.shape[0]
    acc = torch.zeros((E, AGG_STATS * n_agg + AGG_TOTALS), dtype=torch.int32,
                      device=msgs.device)
    tids = tids.to(device=msgs.device, dtype=torch.int32)

    def on_fills(m, s, tid, Xp, Xo, Xt, matched, was, total_matched):
        col = lambda v: v[:, None]                          # noqa: E731
        if n_agg:
            mpt = matched * torch.div(Xp, tick, rounding_mode="floor")
            mt = matched * Xt
            s_pos = col(s == 1)

            def rsum(mask, v):
                return _isum(torch.where(mask, v, 0))

            n_acc = acc.shape[1]
            acc[:, n_acc - 2] += total_matched
            acc[:, n_acc - 1] += rsum(was, mpt)
            for k in range(n_agg):
                tk = tids[k]
                pmask = was & (Xt == tk)
                agr_rows = was & col(tid == tk)
                involved = pmask | agr_rows
                buy_rows = (s_pos & agr_rows) | (~s_pos & pmask)
                sell_rows = (s_pos & pmask) | (~s_pos & agr_rows)
                o = AGG_STATS * k
                acc[:, o + 0] += rsum(buy_rows, matched)
                acc[:, o + 1] += rsum(sell_rows, matched)
                acc[:, o + 2] += rsum(buy_rows, mpt)
                acc[:, o + 3] += rsum(sell_rows, mpt)
                acc[:, o + 4] += rsum(involved, matched)
                acc[:, o + 5] += rsum(involved, mpt)
                acc[:, o + 6] += rsum(involved, mt)
                acc[:, o + 7] += -s * rsum(involved, matched)

    book, bidask = _scan_reference(cfg, msgs, book, prev_prices, uniforms,
                                   on_fills)
    per_agent = acc[:, :AGG_STATS * n_agg].reshape(E, n_agg, AGG_STATS)
    totals = acc[:, AGG_STATS * n_agg:]
    return (book, (bidask[:, :, 0:2], bidask[:, :, 2:4]), (per_agent, totals))


def process_step_records_reference(cfg: EngineConfig, msgs: torch.Tensor,
                                   book: BookState,
                                   prev_prices: torch.Tensor,
                                   rec_k: int = REC_K,
                                   uniforms: Optional[torch.Tensor] = None):
    """Plain PyTorch book scan in records mode; same arguments and results
    as :func:`process_step_records` (the records branch of the Pallas
    kernel, ``_make_kernel`` with ``want_records``).

    Message ``m``'s fills are ranked in slot order; fill ``r`` (1-based)
    with ``r <= rec_k`` becomes row ``r - 1`` of ``records[:, m]``:
    (price, ``-side * matched``, passive oid, passive tid).  The other rows
    are empty, ``(EMPTY_SLOT, 0, 0, 0)``.  ``fill_counts[:, m]`` is the
    number of fills, uncapped.
    """
    E, M, _ = msgs.shape
    dev = msgs.device
    records = torch.empty((E, M, rec_k, N_REC_PLANES), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((E, M), dtype=torch.int32, device=dev)
    empty = torch.tensor(EMPTY_RECORD, dtype=torch.int32, device=dev)

    def on_fills(m, s, tid, Xp, Xo, Xt, matched, was, total_matched):
        rank = was.to(torch.int32).cumsum(dim=-1, dtype=torch.int32)
        counts[:, m] = rank[:, -1]
        # fills past rec_k go to a spare row that is dropped
        idx = torch.where(was & (rank <= rec_k), rank - 1, rec_k).long()
        vals = torch.stack([Xp, -s[:, None] * matched, Xo, Xt], dim=-1)
        rows = empty.repeat(E, rec_k + 1, 1)
        rows.scatter_(1, idx[..., None].expand(-1, -1, N_REC_PLANES), vals)
        records[:, m] = rows[:, :rec_k]

    book, bidask = _scan_reference(cfg, msgs, book, prev_prices, uniforms,
                                   on_fills)
    return (book, (bidask[:, :, 0:2], bidask[:, :, 2:4]), (records, counts))


# --------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# --------------------------------------------------------------------------


def capacity_route(S: int) -> Tuple[int, bool]:
    """The CUDA kernel's slot map for book capacity ``S``: ``(slots a
    lane, masked)``.  The capacities of ``EXACT_CAPACITIES`` fill the 32
    lanes of a warp (``S / 32`` slots a lane); any other ``S`` up to
    ``WARP_CAPACITY`` takes the power of two of at least ``S / 32`` slots
    a lane with the slots past ``S`` masked; past it, ``(BLOCK_ROUTE,
    False)``: a block of threads an env, each thread ``ceil(S / 256)``
    consecutive slots, nothing masked.  Raises ``ValueError`` for
    ``S < 1``."""
    if S < 1:
        raise ValueError(f"book capacity {S}: n_orders must be at least 1")
    if S > WARP_CAPACITY:
        return BLOCK_ROUTE, False
    spl = 1 << (-(-S // 32) - 1).bit_length()
    return spl, S not in EXACT_CAPACITIES

_lib = None
_lib_lock = threading.Lock()
NVCC_FLAGS = ("--split-compile=0",)


def build_library() -> str:
    """Compile ``csrc/book_scan.cu`` (see ``ops/nvcc.py``); returns the
    library's path.  Its 48 kernels (the slot maps times the modes, and
    the block route's 4) are optimised in parallel
    (``--split-compile``)."""
    return nvcc.build(SOURCE, "libbook_scan.so", NVCC_FLAGS)


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.book_scan_aggs.argtypes = [p, p, p, p, p, p, p, p,
                                           *[i] * 11, p]
            lib.book_scan_aggs.restype = i
            lib.book_scan_records.argtypes = [p, p, p, p, p, p, p, p,
                                              *[i] * 10, p]
            lib.book_scan_records.restype = i
            lib.book_scan_plan.argtypes = [i, i, i, i, i, p]
            lib.book_scan_plan.restype = i
            lib.book_scan_error_string.argtypes = [i]
            lib.book_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def launch_plan(S: int, n_agg: Optional[int], device, rec_k: int = 1) -> dict:
    """How the kernel for book capacity ``S`` runs on ``device``: records
    mode for ``n_agg=None`` (the kernel that ``rec_k`` takes: rows wider
    than 96 records have a kernel of their own up to 256 slots), else the
    aggregate kernel for ``n_agg`` traders.  The slot map
    (:func:`capacity_route`: slots a lane, masked), registers and spill
    bytes a thread, dynamic shared bytes a block (what each launch asks
    for), resident blocks and warps an SM, threads an env (a warp, or a
    block of 256 on the block route) and whether the block route keeps
    the book in device memory (past what shared memory holds), from the
    CUDA runtime; worked out once per (S, mode, n_agg, rec_k, device),
    before the kernel's first launch there."""
    with torch.cuda.device(device):
        return _plan(_library(), S, *capacity_route(S), n_agg, rec_k)


def _plan(lib, S: int, spl: int, masked: bool, n_agg: Optional[int],
          rec_k: int) -> dict:
    """:func:`launch_plan` of the library ``lib`` on the current device,
    for the slot map ``(spl, masked)``."""
    out = (ctypes.c_int * 6)()
    err = lib.book_scan_plan(S, spl, int(masked),
                             -1 if n_agg is None else n_agg, rec_k, out)
    _raise_on(err, lib, "book_scan_plan")
    return dict(slots_per_lane=spl, masked=masked, registers=out[0],
                spill_bytes=out[1], dynamic_smem=out[2],
                blocks_per_sm=out[3], warps_per_sm=out[3] * out[4] // 32,
                threads_per_env=32 if spl != BLOCK_ROUTE else out[4],
                book_in_device_memory=bool(out[5]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel reads the
    messages and the book with 16-byte loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_inputs(cfg: EngineConfig, msgs, book: BookState, prev, uniforms):
    """Checked, contiguous int32 inputs of both kernels and the uniforms'
    pointer (None outside the random-cancel modes)."""
    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    dev = msgs.device
    capacity_route(S)
    msgs = _aligned(msgs.to(torch.int32))
    book_in = _aligned(book.data)
    prev = prev.to(torch.int32).contiguous()
    _check(book_in, "book", (E, 2, 6, S), torch.int32, dev)
    _check(prev, "prev_prices", (E, 2), torch.int32, dev)
    u_ptr = None
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM:
        uniforms = uniforms.contiguous()
        _check(uniforms, "uniforms", (M, E), torch.float32, dev)
        u_ptr = uniforms.data_ptr()
    return msgs, book_in, prev, uniforms, u_ptr


def _raise_on(err: int, lib, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.book_scan_error_string(err).decode())


def _launch(cfg: EngineConfig, msgs, book: BookState, tids, prev, tick,
            uniforms):
    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    n_agg = tids.shape[0]
    dev = msgs.device
    if tick <= 0:
        raise ValueError(f"tick must be positive, got {tick}")
    msgs, book_in, prev, uniforms, u_ptr = _kernel_inputs(
        cfg, msgs, book, prev, uniforms)
    tids = tids.to(device=dev, dtype=torch.int32).contiguous()
    book_out = torch.empty_like(book_in)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    n_acc = AGG_STATS * n_agg + AGG_TOTALS
    aggs = torch.empty((E, n_acc), dtype=torch.int32, device=dev)
    lib = _library()
    plan = launch_plan(S, n_agg, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.book_scan_aggs(
            msgs.data_ptr(), book_in.data_ptr(), prev.data_ptr(),
            tids.data_ptr(), u_ptr, book_out.data_ptr(), bidask.data_ptr(),
            aggs.data_ptr(), E, M, S, plan["slots_per_lane"],
            int(plan["masked"]), n_agg, int(cfg.cancel_mode),
            int(cfg.init_id), int(tick), int(cfg.maxint),
            plan["dynamic_smem"], stream)
    _raise_on(err, lib, "book_scan_aggs")
    tally(book_out, process_step_aggs, "launches")
    per_agent = aggs[:, :AGG_STATS * n_agg].reshape(E, n_agg, AGG_STATS)
    return (BookState(book_out), (bidask[:, :, 0:2], bidask[:, :, 2:4]),
            (per_agent, aggs[:, AGG_STATS * n_agg:]))


def _launch_records(cfg: EngineConfig, msgs, book: BookState, prev,
                    rec_k: int, uniforms):
    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    dev = msgs.device
    msgs, book_in, prev, uniforms, u_ptr = _kernel_inputs(
        cfg, msgs, book, prev, uniforms)
    book_out = torch.empty_like(book_in)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    records = torch.empty((E, M, rec_k, N_REC_PLANES), dtype=torch.int32,
                          device=dev)
    counts = torch.empty((E, M), dtype=torch.int32, device=dev)
    lib = _library()
    plan = launch_plan(S, None, dev, rec_k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.book_scan_records(
            msgs.data_ptr(), book_in.data_ptr(), prev.data_ptr(), u_ptr,
            book_out.data_ptr(), bidask.data_ptr(), records.data_ptr(),
            counts.data_ptr(), E, M, S, plan["slots_per_lane"],
            int(plan["masked"]), rec_k, int(cfg.cancel_mode),
            int(cfg.init_id), int(cfg.maxint), plan["dynamic_smem"], stream)
    _raise_on(err, lib, "book_scan_records")
    tally(book_out, process_step_records, "launches")
    return (BookState(book_out), (bidask[:, :, 0:2], bidask[:, :, 2:4]),
            (records, counts))


def _default_prev(msgs: torch.Tensor, prev_prices):
    if prev_prices is None:
        return torch.full((msgs.shape[0], 2), EMPTY_SLOT, dtype=torch.int32,
                          device=msgs.device)
    return prev_prices


def _route(cfg: EngineConfig, msgs: torch.Tensor, uniforms) -> bool:
    """True for the plain version (a CPU tensor), False for the kernel (a
    CUDA tensor); raises on any other device or missing uniforms."""
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM and uniforms is None:
        raise ValueError("cancel_mode >= CANCEL_UNIFORM needs uniforms: "
                         "(M, E) float32 draws in [0, 1)")
    if msgs.device.type == "cpu":
        return True
    if msgs.device.type != "cuda":
        raise ValueError(f"unsupported device {msgs.device}")
    return False


def process_step_aggs(cfg: EngineConfig, msgs: torch.Tensor, book: BookState,
                      tids: torch.Tensor,
                      prev_prices: Optional[torch.Tensor] = None,
                      tick: int = 100,
                      uniforms: Optional[torch.Tensor] = None
                      ) -> Tuple[BookState, Tuple[torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Process one step's messages for a batch of environments.

    Args:
      msgs: (E, M, 8) int32 per-env message streams.
      book: books, ``data`` (E, 2, 6, S) int32, any S >= 1
        (:func:`capacity_route`).
      tids: (n_agg,) int32 trader ids, ordered [type 0 instances..., type 1
        instances, ...] as ``WorldEnv`` assigns them.
      prev_prices: (E, 2) int32 [last ask, last bid] seeding the forward
        fill of invalid best prices (omit for a -1 seed).
      uniforms: (M, E) float32 uniform draws in [0, 1), one per message and
        env; read only in the random-cancel modes (cancel_mode >= 2).

    Returns:
      (book', (bestasks (E, M, 2), bestbids (E, M, 2)) forward-filled,
       (per_agent (E, n_agg, 8), totals (E, 2))), all int32.
    """
    prev_prices = _default_prev(msgs, prev_prices)
    if _route(cfg, msgs, uniforms):
        return process_step_aggs_reference(cfg, msgs, book, tids,
                                           prev_prices, tick, uniforms)
    return _launch(cfg, msgs, book, tids, prev_prices, tick, uniforms)


process_step_aggs.launches = 0


def process_step_records(cfg: EngineConfig, msgs: torch.Tensor,
                         book: BookState,
                         prev_prices: Optional[torch.Tensor] = None,
                         rec_k: int = REC_K,
                         uniforms: Optional[torch.Tensor] = None
                         ) -> Tuple[BookState,
                                    Tuple[torch.Tensor, torch.Tensor],
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """Process one step's messages and record every message's fills: the
    counterpart of ``vit_marl_tpu/ops/book_kernel.py::pallas_process_step``
    (the ``debug_mode`` trade log).

    Args: as :func:`process_step_aggs`, without trader ids; ``rec_k``
    (1 to S) is the number of fills recorded per message.

    Returns:
      (book', (bestasks (E, M, 2), bestbids (E, M, 2)) forward-filled,
       (records (E, M, rec_k, 4), fill_counts (E, M))), all int32.  Row
      ``r`` of ``records[e, m]`` is the message's fill of rank ``r + 1``
      in slot order, (price, -side * quant, passive oid, passive tid);
      rows from ``min(fill_counts[e, m], rec_k)`` on are
      ``(EMPTY_SLOT, 0, 0, 0)``.  ``fill_counts`` is not capped, so a
      message with more than ``rec_k`` fills shows as such.
    """
    S = book.data.shape[-1]
    if not 1 <= rec_k <= S:
        raise ValueError(f"rec_k must be in [1, n_orders={S}], got {rec_k}")
    prev_prices = _default_prev(msgs, prev_prices)
    if _route(cfg, msgs, uniforms):
        return process_step_records_reference(cfg, msgs, book, prev_prices,
                                              rec_k, uniforms)
    return _launch_records(cfg, msgs, book, prev_prices, rec_k, uniforms)


process_step_records.launches = 0


def finalize_trade_log_from_records(trades0: torch.Tensor,
                                    records: torch.Tensor,
                                    msgs: torch.Tensor,
                                    fill_counts: torch.Tensor
                                    ) -> torch.Tensor:
    """The ``(E, n_trades, 8)`` trade log from the records of
    :func:`process_step_records` and the step's messages (port of
    ``vit_marl_tpu/ops/book_kernel.py::finalize_trade_log_from_records``,
    batched over envs).

    Rows of ``trades0`` with a price other than ``EMPTY_SLOT`` stay; the
    step's fills follow them in message order, then rank order, as
    ``[price, quant, pass_oid, agr_oid, time_s, time_ns, pass_tid,
    agr_tid]``.  A message contributes at most ``rec_k`` fills.  When the
    fills overflow the log, its last row holds the step's last fill.
    """
    E, M, K, _ = records.shape
    cap = trades0.shape[1]
    dev = records.device
    flat = records.reshape(E, M * K, N_REC_PLANES)
    counts = torch.clamp(fill_counts.to(torch.int32), max=K)
    cm = counts.cumsum(dim=1, dtype=torch.int32)           # (E, M)
    total = cm[:, -1:]                                     # (E, 1)
    tc0 = (trades0[:, :, 0] != EMPTY_SLOT).sum(dim=1, dtype=torch.int32)
    t = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    new_rank = t - tc0[:, None]                            # (E, cap)

    def rank_to_src(r):
        # the first message whose cumulative count exceeds r
        m_of = torch.searchsorted(cm, r, right=True).to(torch.int32)
        m_c = torch.clamp(m_of, max=M - 1)
        before = torch.where(
            m_of > 0, torch.gather(cm, 1, (m_of - 1).clamp(min=0).long()), 0)
        return m_c * K + (r - before), m_c

    src, msg_idx = rank_to_src(new_rank)
    overflow = total + tc0[:, None] > cap                  # (E, 1)
    last_src, last_m = rank_to_src((total - 1).expand(E, cap).contiguous())
    is_last_slot = (t == cap - 1) & overflow
    src = torch.where(is_last_slot, last_src, src)
    msg_idx = torch.where(is_last_slot, last_m, msg_idx)
    have_new = (((new_rank >= 0) & (new_rank < total))
                | (is_last_slot & (total > 0)))
    src_c = torch.clamp(src, 0, M * K - 1).long()
    planes = torch.gather(flat, 1, src_c[..., None].expand(-1, -1, 4))
    msg_of = torch.gather(msgs.to(torch.int32), 1,
                          msg_idx.long()[..., None].expand(-1, -1, 8))
    rows = torch.stack([
        planes[..., 0], planes[..., 1], planes[..., 2], msg_of[..., 4],
        msg_of[..., 6], msg_of[..., 7], planes[..., 3], msg_of[..., 5],
    ], dim=-1)
    return torch.where(have_new[..., None], rows, trades0)
