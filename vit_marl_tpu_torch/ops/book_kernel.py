"""Book scan in aggregate mode: one step's messages against a batch of books.

Replaces the TPU kernel ``vit_marl_tpu/ops/book_kernel.py::
pallas_process_step_aggs`` (body ``_make_kernel``, aggregate mode).  Per
env, the step's M messages run in order against the book: (type, side)
dispatch, the cancel fallback chain, matching by prefix sum over the
crossing slots, the hole-arena insert, the forward-filled best ask/bid
after every message, and exact int32 per-trader trade sums in tick units
(the ``TradeSummary`` contract of ``env/common.py::summary_from_aggs``).

Two implementations of one function:

- :func:`process_step_aggs_reference`, plain PyTorch on ``(E, S)`` tensors,
  a line-by-line transcription of the Pallas kernel;
- ``csrc/book_scan.cu``, the CUDA kernel (one warp per env).

:func:`process_step_aggs` is the wrapper the environment calls.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``process_step_aggs.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
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
from vit_marl_tpu_torch.ops import nvcc

AGG_STATS = 8    # buy_q, sell_q, buy_pqt, sell_pqt, a_q, a_pqt, dur, signed
AGG_TOTALS = 2   # total_q, total_pq_tick

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


def process_step_aggs_reference(cfg: EngineConfig, msgs: torch.Tensor,
                                book: BookState, tids: torch.Tensor,
                                prev_prices: torch.Tensor, tick: int,
                                uniforms: Optional[torch.Tensor] = None):
    """Plain PyTorch book scan; same arguments and results as
    :func:`process_step_aggs`.

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
    n_agg = tids.shape[0]
    iota = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    rows = torch.arange(E, device=dev)

    bk = book.data.clone()                    # (E, 2, 6, S)
    acc = torch.zeros((E, AGG_STATS * n_agg + AGG_TOTALS), dtype=torch.int32,
                      device=dev)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    prev_a = prev_prices[:, 0].to(torch.int32)
    prev_b = prev_prices[:, 1].to(torch.int32)
    tids = tids.to(device=dev, dtype=torch.int32)

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
    bk = torch.where(hole, EMPTY_SLOT, bk)
    per_agent = acc[:, :AGG_STATS * n_agg].reshape(E, n_agg, AGG_STATS)
    totals = acc[:, AGG_STATS * n_agg:]
    return (BookState(bk), (bidask[:, :, 0:2], bidask[:, :, 2:4]),
            (per_agent, totals))


# --------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile ``csrc/book_scan.cu`` (see ``ops/nvcc.py``); returns the
    library's path."""
    return nvcc.build(SOURCE, "libbook_scan.so")


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.book_scan_aggs.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, i, p]
            lib.book_scan_aggs.restype = i
            lib.book_scan_error_string.argtypes = [i]
            lib.book_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(cfg: EngineConfig, msgs, book: BookState, tids, prev, tick,
            uniforms):
    E, M, _ = msgs.shape
    S = book.data.shape[-1]
    n_agg = tids.shape[0]
    dev = msgs.device
    if S not in (32, 64, 128, 256):
        raise ValueError(f"book capacity {S}: the CUDA kernel takes "
                         "n_orders in (32, 64, 128, 256)")
    if tick <= 0:
        raise ValueError(f"tick must be positive, got {tick}")
    msgs = msgs.to(torch.int32).contiguous()
    book_in = book.data.contiguous()
    prev = prev.to(torch.int32).contiguous()
    tids = tids.to(device=dev, dtype=torch.int32).contiguous()
    _check(book_in, "book", (E, 2, 6, S), torch.int32, dev)
    _check(prev, "prev_prices", (E, 2), torch.int32, dev)
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM:
        uniforms = uniforms.contiguous()
        _check(uniforms, "uniforms", (M, E), torch.float32, dev)
        u_ptr = uniforms.data_ptr()
    else:
        u_ptr = None
    book_out = torch.empty_like(book_in)
    bidask = torch.empty((E, M, 4), dtype=torch.int32, device=dev)
    n_acc = AGG_STATS * n_agg + AGG_TOTALS
    aggs = torch.empty((E, n_acc), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.book_scan_aggs(
            msgs.data_ptr(), book_in.data_ptr(), prev.data_ptr(),
            tids.data_ptr(), u_ptr, book_out.data_ptr(), bidask.data_ptr(),
            aggs.data_ptr(), E, M, S, n_agg, int(cfg.cancel_mode),
            int(cfg.init_id), int(tick), int(cfg.maxint), stream)
    if err != 0:
        raise RuntimeError("book_scan_aggs launch failed: "
                           + lib.book_scan_error_string(err).decode())
    process_step_aggs.launches += 1
    per_agent = aggs[:, :AGG_STATS * n_agg].reshape(E, n_agg, AGG_STATS)
    return (BookState(book_out), (bidask[:, :, 0:2], bidask[:, :, 2:4]),
            (per_agent, aggs[:, AGG_STATS * n_agg:]))


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
      book: books, ``data`` (E, 2, 6, S) int32.
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
    E = msgs.shape[0]
    if prev_prices is None:
        prev_prices = torch.full((E, 2), EMPTY_SLOT, dtype=torch.int32,
                                 device=msgs.device)
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM and uniforms is None:
        raise ValueError("cancel_mode >= CANCEL_UNIFORM needs uniforms: "
                         "(M, E) float32 draws in [0, 1)")
    if msgs.device.type == "cpu":
        return process_step_aggs_reference(cfg, msgs, book, tids,
                                           prev_prices, tick, uniforms)
    if msgs.device.type != "cuda":
        raise ValueError(f"unsupported device {msgs.device}")
    return _launch(cfg, msgs, book, tids, prev_prices, tick, uniforms)


process_step_aggs.launches = 0
