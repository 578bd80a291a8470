"""The sorted-arena matching engine, message by message.

Port of ``vit_marl_tpu/lob/engine.py``, the JAX package's XLA scan: its
docstring has the design (the sorted-arena invariant, holes, matching by
prefix sums over the crossing slots, the insert's three cases, the
three-stage cancel fallback, the trade log built from per-message match
records) and the documented divergences from the reference.  The JAX
functions take one book and gain the env axis with ``vmap``; here each
takes the whole batch, ``book.data`` ``(E, 2, 6, S)`` int32, and runs the
messages in order in a host loop of plain PyTorch on whatever device the
tensors are on.

These are this engine's semantics, which differ from the book-scan
kernel's (``ops/book_kernel.py``) on corner books: the engine reads every
plane of a slot as it stands (the stale planes of an input book's holes
stay, and a cancel can match a hole's order id), signs a fill's quantity
as ``-side * q`` for any side, and records every fill of a message.  The
kernel is the training path; this engine is the independent oracle and
the :class:`~vit_marl_tpu_torch.lob.orderbook.OrderBook` facade's engine.

The port's :class:`BookState` carries no trade log, so the engine takes
and returns ``(book, trades)``, ``trades`` ``(E, n_trades, 8)`` int32.
Randomness is an input: the random-cancel stages (cancel modes 2 and 3)
read one float32 uniform a message and env, ``(M, E)``, as
``ops/book_kernel.py::process_step_aggs`` does; with ``generator=`` they
are drawn from it, and with neither those modes raise.  The JAX engine
splits one key a message and both random stages draw ``uniform(split(
key)[0])``, so mode 3's second stage reuses the first's uniform here too.
"""

from __future__ import annotations

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
    SideState,
    best_bid_and_ask_incl_quants,
)

Tensor = torch.Tensor


def _first_index(mask: Tensor) -> Tensor:
    """``(E,)`` first slot of ``mask`` ``(E, S)``, -1 where it is empty."""
    return torch.where(mask.any(dim=1), mask.to(torch.int8).argmax(dim=1), -1)


def _last_index(mask: Tensor) -> Tensor:
    S = mask.shape[1]
    return S - 1 - mask.flip(1).to(torch.int8).argmax(dim=1)


def _wipe(side: Tensor, mask: Tensor) -> Tensor:
    """Slots of ``mask`` ``(E, S)`` become holes in every plane of
    ``side`` ``(E, 6, S)``."""
    return torch.where(mask[:, None, :], EMPTY_SLOT, side)


def _sel(pred: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Per env ``a`` where ``pred`` ``(E,)`` else ``b``."""
    return torch.where(pred.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _insert_sorted(side: Tensor, side_is_ask: Tensor, price, quant, oid, tid,
                   time_s, time_ns) -> Tensor:
    """Each env's order (``(E,)`` fields) into its side ``(E, 6, S)`` at
    its priority position (ref: ``engine.py::_insert_sorted``): case A
    writes a hole between the last better and the first worse slot; case
    B shifts the worse segment right by one into the first hole after it,
    or off the end of a full side; case C shifts the better segment left
    by one into the last hole before it."""
    E, _, S = side.shape
    col = lambda v: v[:, None]                              # noqa: E731
    idx = torch.arange(S, device=side.device)[None, :]
    p, ts, tns = side[:, PRICE], side[:, TS], side[:, TNS]
    occupied = p != EMPTY_SLOT
    hole = ~occupied
    ask = col(side_is_ask)
    price_key = torch.where(ask, p, -p)
    new_key = col(torch.where(side_is_ask, price, -price))
    better = occupied & ((price_key < new_key) | ((price_key == new_key) & (
        (ts < col(time_s)) | ((ts == col(time_s)) & (tns <= col(time_ns))))))
    worse = occupied & ~better

    fw = col(torch.where(worse.any(dim=1), _first_index(worse), S))
    lb = col(torch.where(better.any(dim=1), _last_index(better), -1))
    in_window = hole & (idx > lb) & (idx < fw)
    case_a = in_window.any(dim=1, keepdim=True)
    pos_a = col(_first_index(in_window))
    hole_after = hole & (idx >= fw)
    case_b_hole = hole_after.any(dim=1, keepdim=True)
    ha = torch.where(case_b_hole, col(_first_index(hole_after)), S - 1)
    hole_before = hole & (idx <= lb)
    case_c = hole_before.any(dim=1, keepdim=True)
    hb = col(_last_index(hole_before))
    use_b = ~case_a & (case_b_hole | ~case_c)
    fw_b = torch.where(case_b_hole, fw, torch.clamp(fw, max=S - 1))

    vals = torch.stack([price, quant, oid, tid, time_s, time_ns], dim=1)
    v = vals[:, :, None].to(side.dtype)                     # (E, 6, 1)
    a3, b3 = case_a[:, None], use_b[:, None]
    out_a = torch.where((idx == pos_a)[:, None], v, side)
    right = torch.roll(side, 1, dims=2)
    out_b = torch.where(((idx > fw_b) & (idx <= ha))[:, None], right, side)
    out_b = torch.where((idx == fw_b)[:, None], v, out_b)
    left = torch.roll(side, -1, dims=2)
    out_c = torch.where(((idx >= hb) & (idx < lb))[:, None], left, side)
    out_c = torch.where((idx == lb)[:, None], v, out_c)
    return torch.where(a3, out_a, torch.where(b3, out_b, out_c))


def _limit_pass(opp: Tensor, same: Tensor, opp_is_ask: Tensor, price, quant,
                oid, tid, time_s, time_ns, raw_side
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Each env's aggressor against ``opp``; the remainder rests on
    ``same`` (ref: ``engine.py::_limit_pass``).  Fills are
    ``clip(Q - exclusive_cumsum(q), 0, q)`` over the crossing slots, in
    int32 with wraparound.  Returns the two sides and the message's match
    records ``(E, S, 8)``: a trade row for every matched slot, price -1
    elsewhere."""
    col = lambda v: v[:, None]                              # noqa: E731
    p, q_all = opp[:, PRICE], opp[:, QUANT]
    occupied = p != EMPTY_SLOT
    crossing = occupied & torch.where(col(opp_is_ask), p <= col(price),
                                      p >= col(price))
    q = torch.where(crossing, q_all, 0)
    cum_before = q.cumsum(dim=1, dtype=torch.int32) - q
    matched = torch.where(crossing, torch.minimum(
        torch.clamp(col(quant) - cum_before, min=0), q), 0)
    remaining = quant - matched.sum(dim=1, dtype=torch.int32)
    was_matched = matched > 0

    full = lambda v: col(v).expand_as(p)                    # noqa: E731
    rows = torch.stack([
        torch.where(was_matched, p, EMPTY_SLOT),
        -col(raw_side) * matched,
        opp[:, OID], full(oid), full(time_s), full(time_ns),
        opp[:, TID], full(tid)], dim=2).to(torch.int32)

    new_q = q_all - matched
    opp = torch.cat([opp[:, :QUANT], new_q[:, None], opp[:, QUANT + 1:]], 1)
    opp = _wipe(opp, was_matched & (new_q <= 0))

    add_q = torch.clamp(remaining, min=0)
    inserted = _insert_sorted(same, ~opp_is_ask, price, add_q, oid, tid,
                              time_s, time_ns)
    return opp, _sel(add_q > 0, inserted, same), rows


def finalize_trade_log(trades0: Tensor, records: Tensor) -> Tensor:
    """The ``(E, cap, 8)`` trade logs: each env's rows of ``trades0`` whose
    price is not -1 stay, and the valid rows of ``records`` ``(E, M, S,
    8)`` (price not -1) follow in message and slot order.  When they
    overflow the log, its last row holds the last fill, as the
    reference's repeated ``.at[-1]`` writes leave it (ref:
    ``engine.py::finalize_trade_log``: a cumsum, a searchsorted and a
    gather)."""
    E, cap, _ = trades0.shape
    flat = records.reshape(E, -1, records.shape[-1])
    n = flat.shape[1]
    valid = flat[..., 0] != EMPTY_SLOT
    cm = valid.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    total = cm[:, -1:]
    tc0 = (trades0[..., 0] != EMPTY_SLOT).sum(dim=1, dtype=torch.int32)
    t = torch.arange(cap, dtype=torch.int32, device=flat.device)[None, :]
    new_rank = t - tc0[:, None]
    src = torch.searchsorted(cm, (new_rank + 1).contiguous())
    overflow = total + tc0[:, None] > cap
    last_src = torch.searchsorted(cm, total.contiguous())
    last_slot = (t == cap - 1) & overflow
    src = torch.where(last_slot, last_src, src)
    have_new = (((new_rank >= 0) & (new_rank < total))
                | (last_slot & (total > 0)))
    gathered = torch.gather(flat, 1, torch.clamp(src, max=n - 1)[..., None]
                            .expand(E, cap, flat.shape[-1]))
    return torch.where(have_new[..., None], gathered, trades0)


def _random_id_pick(u: Tensor, side: Tensor, mask: Tensor) -> Tensor:
    """Uniform pick among the slots of ``mask`` with a nonzero order id,
    by the float32 CDF of the uniforms ``u`` ``(E,)``; the slot of the
    picked id's first order, -1 where there is no candidate
    (ref: ``engine.py::_random_id_pick``)."""
    oid = side[:, OID]
    ids = torch.where(mask, oid, 0)
    weights = (ids != 0).to(torch.float32)
    total = weights.sum(dim=1)
    uu = u.to(torch.float32) * torch.clamp(total, min=1.0)
    cdf = weights.cumsum(dim=1)
    pick = (cdf > uu[:, None]).to(torch.int8).argmax(dim=1)
    chosen = torch.gather(ids, 1, pick[:, None])
    idx = _first_index(oid == chosen)
    return torch.where(total > 0, idx, -1)


def _cancel(cfg: EngineConfig, u: Optional[Tensor], side: Tensor, price,
            quant, oid) -> Tensor:
    """The cancel fallback chain on ``side`` ``(E, 6, S)``
    (ref: ``engine.py::_cancel``): the first slot of the order id, then
    the first init order at the price with enough quantity, then a
    uniform pick at the price with enough quantity, then a uniform pick
    at the price; the order is decremented and wiped when empty."""
    col = lambda v: v[:, None]                              # noqa: E731
    p, q, o = side[:, PRICE], side[:, QUANT], side[:, OID]
    idx = _first_index(o == col(oid))
    if cfg.cancel_mode >= CancelMode.INCLUDE_INITS:
        m2 = (p == col(price)) & (o <= cfg.init_id) & (q >= col(quant))
        idx = torch.where(idx == -1, _first_index(m2), idx)
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM:
        m3 = (p == col(price)) & (q >= col(quant))
        idx = torch.where(idx == -1, _random_id_pick(u, side, m3), idx)
    if cfg.cancel_mode >= CancelMode.CANCEL_UNIFORM_AND_LARGE:
        m3b = p == col(price)
        idx = torch.where(idx == -1, _random_id_pick(u, side, m3b), idx)

    found = idx >= 0
    pos = torch.clamp(idx, min=0)
    new_q = torch.gather(q, 1, pos[:, None])[:, 0] - quant
    at = torch.arange(p.shape[1], device=p.device)[None, :] == col(pos)
    dec_q = torch.where(at, q - col(quant), q)
    decremented = torch.cat([side[:, :QUANT], dec_q[:, None],
                             side[:, QUANT + 1:]], dim=1)
    removed = _wipe(decremented, at)
    updated = _sel(new_q <= 0, removed, decremented)
    return _sel(found, updated, side)


def _process_message_core(cfg: EngineConfig, data: Tensor,
                          u: Optional[Tensor], msg: Tensor
                          ) -> Tuple[Tensor, Tensor]:
    """One message a env, ``msg`` ``(E, 8)``, against ``data`` ``(E, 2, 6,
    S)``; returns the new book data and the match records ``(E, S, 8)``
    (ref: ``engine.py::_process_message_core``).

    The (type, side) dispatch of the reference runs as masks.  Y is the
    bid side for a bid limit or a bid cancel and the ask side otherwise,
    X the other: the cancel pass targets Y, the limit pass matches
    against X and rests the remainder on Y, and each pass is an identity
    where its message kind does not apply (a zero quantity, order id 0)."""
    msg = msg.to(torch.int32)
    t, s, quant, price, oid, tid, time_s, time_ns = msg.unbind(1)
    index = ((((s == -1) & (t == 1)) | ((s == 1) & (t == 4))).int() * 0
             + (((s == 1) & (t == 1)) | ((s == -1) & (t == 4))).int() * 1
             + (((s == -1) & (t == 2)) | ((s == -1) & (t == 3))).int() * 2
             + (((s == 1) & (t == 2)) | ((s == 1) & (t == 3))).int() * 3
             + ((s == 0) & (t == 0)).int() * 4)
    is_bid_lim = index == 1
    is_lim = (index == 0) | is_bid_lim
    is_bid_cancel = index == 3
    is_cancel = (index == 2) | is_bid_cancel
    bid_frame = is_bid_lim | is_bid_cancel

    X = _sel(bid_frame, data[:, ASK], data[:, BID])
    Y = _sel(bid_frame, data[:, BID], data[:, ASK])
    Y = _cancel(cfg, u, Y, price, torch.where(is_cancel, quant, 0),
                torch.where(is_cancel, oid, 0))
    X, Y, rows = _limit_pass(X, Y, is_bid_lim, price,
                             torch.where(is_lim, quant, 0), oid, tid,
                             time_s, time_ns, s)
    asks = _sel(bid_frame, X, Y)
    bids = _sel(bid_frame, Y, X)
    return torch.stack([asks, bids], dim=1), rows


def _message_uniforms(cfg: EngineConfig, n_msgs: int, n_envs: int,
                     uniforms: Optional[Tensor],
                     generator: Optional[torch.Generator],
                     device: torch.device) -> Optional[Tensor]:
    """The random-cancel uniforms ``(M, E)`` float32: ``uniforms`` as
    given, else drawn from ``generator``; ``None`` outside cancel modes 2
    and 3.  Raises in those modes when neither is given."""
    if cfg.cancel_mode < CancelMode.CANCEL_UNIFORM:
        return None
    if uniforms is None:
        if generator is None:
            raise ValueError(
                "cancel_mode >= CANCEL_UNIFORM needs uniforms: (M, E) "
                "float32 draws in [0, 1), or a torch.Generator")
        uniforms = torch.rand((n_msgs, n_envs), generator=generator,
                              device=generator.device)
    uniforms = uniforms.to(device=device, dtype=torch.float32)
    if tuple(uniforms.shape) != (n_msgs, n_envs):
        raise ValueError(f"uniforms: want ({n_msgs}, {n_envs}), got "
                         f"{tuple(uniforms.shape)}")
    return uniforms


def _scan(cfg: EngineConfig, msgs: Tensor, book: BookState, uniforms,
          generator, on_book=None) -> Tuple[Tensor, Tensor]:
    """Every message of ``msgs`` ``(E, M, 8)`` in order; returns the final
    book data and the records ``(E, M, S, 8)``.  ``on_book(m, data)`` sees
    the book after each message."""
    E, M, _ = msgs.shape
    u = _message_uniforms(cfg, M, E, uniforms, generator, msgs.device)
    data = book.data
    records = []
    for m in range(M):
        data, rows = _process_message_core(
            cfg, data, None if u is None else u[m], msgs[:, m])
        records.append(rows)
        if on_book is not None:
            on_book(m, data)
    return data, torch.stack(records, dim=1)


def process_message(cfg: EngineConfig, book: BookState, trades: Tensor,
                    msg: Tensor, uniforms: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[BookState, Tensor]:
    """Apply one message a env, ``msg`` ``(E, 8)`` int32; ``uniforms``
    ``(E,)`` in cancel modes 2-3 (ref: ``engine.py::process_message``).
    Returns ``(book, trades)``."""
    u = None if uniforms is None else uniforms.reshape(1, -1)
    data, records = _scan(cfg, msg[:, None], book, u, generator)
    return BookState(data), finalize_trade_log(trades, records)


def process_messages(cfg: EngineConfig, msgs: Tensor, book: BookState,
                     trades: Tensor, uniforms: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[BookState, Tensor]:
    """Every message of ``msgs`` ``(E, M, 8)`` in order against each env's
    book; ``uniforms`` ``(M, E)`` in cancel modes 2-3 (ref:
    ``engine.py::process_messages``, ``scan_through_entire_array``).
    Returns ``(book, trades)``."""
    data, records = _scan(cfg, msgs, book, uniforms, generator)
    return BookState(data), finalize_trade_log(trades, records)


def _last(n_last: int, M: int) -> int:
    """The first message whose result ``seq[-n_last:]`` keeps."""
    return max(M - n_last, 0) if n_last > 0 else 0


def process_messages_save_bidask(cfg: EngineConfig, msgs: Tensor,
                                 book: BookState, trades: Tensor,
                                 n_last: int,
                                 uniforms: Optional[Tensor] = None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> Tuple[BookState, Tensor,
                                            Tuple[Tensor, Tensor]]:
    """:func:`process_messages`, with the best ask and bid ``(E, n_last,
    2)`` [price, quantity] after each of the last ``n_last`` messages, not
    forward-filled (ref: ``engine.py::process_messages_save_bidask``).
    Returns ``(book, trades, (asks, bids))``."""
    first = _last(n_last, msgs.shape[1])
    asks, bids = [], []

    def on_book(m, data):
        if m >= first:
            a, b = best_bid_and_ask_incl_quants(cfg, BookState(data))
            asks.append(a)
            bids.append(b)

    data, records = _scan(cfg, msgs, book, uniforms, generator, on_book)
    return (BookState(data), finalize_trade_log(trades, records),
            (torch.stack(asks, dim=1), torch.stack(bids, dim=1)))


def process_messages_save_states(cfg: EngineConfig, msgs: Tensor,
                                 book: BookState, trades: Tensor,
                                 n_last: int,
                                 uniforms: Optional[Tensor] = None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> Tuple[SideState, SideState, Tensor]:
    """:func:`process_messages`, with both sides after each of the last
    ``n_last`` messages (ref: ``engine.py::process_messages_save_states``).
    Returns ``(asks, bids, trades)``: the sides' fields ``(E, n_last,
    S)``."""
    first = _last(n_last, msgs.shape[1])
    states = []

    def on_book(m, data):
        if m >= first:
            states.append(data)

    _, records = _scan(cfg, msgs, book, uniforms, generator, on_book)
    seq = torch.stack(states, dim=1)                    # (E, n, 2, 6, S)
    side = lambda i: SideState(  # noqa: E731
        *(seq[:, :, i, f] for f in (PRICE, QUANT, OID, TID, TS, TNS)))
    return side(ASK), side(BID), finalize_trade_log(trades, records)
