"""Shared agent machinery: message netting, price forward fill, trade sums.

Port of ``vit_marl_tpu/env/common.py``, batched: message tensors carry
leading ``(E, n)`` env and instance axes, and the trade-log helpers
(:func:`extract_trade_stats`, :func:`add_artificial_trade`) take any
leading axes, none for one env's log as the JAX functions take it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from vit_marl_tpu_torch.config import TradeCol
from vit_marl_tpu_torch.utils.device import const

Tensor = torch.Tensor


def filter_messages(action_msgs: Tensor, cnl_msgs: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Net new orders against same-price cancels
    (ref: mm_env.py:509-571 / vision_env.py:622-684).

    ``action_msgs`` and ``cnl_msgs`` are ``(..., n, 8)``.  When a fresh
    action re-places an order at a price that is about to be cancelled and
    the standing quantity covers the new one, both are reduced so the
    standing order stays (keeping queue priority); the i-th matched action
    pairs with the i-th matched cancel.  Zero-quantity actions become
    all-zero messages.
    """
    a_p = action_msgs[..., :, 3]
    c_p = cnl_msgs[..., :, 3]
    res = (c_p[..., None, :] == a_p[..., :, None]) & (a_p[..., :, None] != 0)
    a_mask = res.any(dim=-1)
    c_mask = res.any(dim=-2)
    n = a_mask.shape[-1]
    ra = a_mask.to(torch.int32).cumsum(dim=-1) - 1
    rc = c_mask.to(torch.int32).cumsum(dim=-1) - 1
    iota = torch.arange(n, device=a_mask.device)[:, None]
    sel_a = a_mask[..., None, :] & (ra[..., None, :] == iota)   # (..., n, n)
    sel_c = c_mask[..., None, :] & (rc[..., None, :] == iota)
    a = torch.where(sel_a, action_msgs[..., None, :, 2], 0).sum(
        dim=-1, dtype=torch.int32)
    c = torch.where(sel_c, cnl_msgs[..., None, :, 2], 0).sum(
        dim=-1, dtype=torch.int32)
    rel = (c >= a).to(torch.int32) * a
    a_q = action_msgs[..., 2] - torch.where(sel_a, rel[..., :, None], 0).sum(
        dim=-2, dtype=torch.int32)
    action_msgs = action_msgs.clone()
    action_msgs[..., 2] = a_q
    action_msgs = torch.where((a_q == 0)[..., None], 0, action_msgs)
    cnl_msgs = cnl_msgs.clone()
    cnl_msgs[..., 2] = cnl_msgs[..., 2] - torch.where(
        sel_c, rel[..., :, None], 0).sum(dim=-2, dtype=torch.int32)
    return action_msgs, cnl_msgs


def ffill_best_prices(prices_quants: Tensor, last_valid_price: Tensor
                      ) -> Tensor:
    """Forward-fill invalid (-1) best prices over a step's messages
    (ref: marl_env.py:685-711); ``(E, M, 2)`` with ``(E,)`` seeds.

    The book scan does this fill itself; this plain version is kept for the
    tests that compare the scan with the trade-log path of the reference.
    """
    pq = prices_quants.clone()
    first_bad = pq[:, 0, 0] == -1
    pq[:, 0, 0] = torch.where(first_bad, last_valid_price, pq[:, 0, 0])
    pq[:, 0, 1] = torch.where(first_bad, 0, pq[:, 0, 1])
    pq[:, :, 1] = torch.where(pq[:, :, 0] == -1, 0, pq[:, :, 1])
    cur = torch.full_like(pq[:, 0, 0], -1)
    for m in range(pq.shape[1]):
        cur = torch.where(pq[:, m, 0] != -1, pq[:, m, 0], cur)
        pq[:, m, 0] = cur
    return pq


class TradeSummary(NamedTuple):
    """Linear per-agent trade statistics, int32, in tick units for money
    (ref: ``vit_marl_tpu/env/common.py::TradeSummary``)."""

    buy_quant: Tensor
    sell_quant: Tensor
    buy_pq_tick: Tensor
    sell_pq_tick: Tensor
    agent_quant_abs: Tensor
    agent_pq_tick: Tensor
    dur_wsum: Tensor
    signed_sum: Tensor
    total_quant: Tensor
    total_pq_tick: Tensor

    @property
    def traded_volume(self) -> Tensor:
        return self.buy_quant + self.sell_quant

    @property
    def inventory_delta(self) -> Tensor:
        return self.buy_quant - self.sell_quant

    @property
    def other_quant(self) -> Tensor:
        return self.total_quant - self.agent_quant_abs

    @property
    def other_pq_tick(self) -> Tensor:
        return self.total_pq_tick - self.agent_pq_tick


class TradeStats(NamedTuple):
    """An agent's trades of a step (ref: common.py:85-96,
    mm_env.py:1906-1937): its rows of the log and the others', its buys and
    sells, and their absolute quantities."""

    agent_trades: Tensor
    other_trades: Tensor
    agent_buys: Tensor
    agent_sells: Tensor
    buy_quant: Tensor
    sell_quant: Tensor
    traded_volume: Tensor
    inventory_delta: Tensor


def extract_trade_stats(trades: Tensor, trader_id) -> TradeStats:
    """Split a ``(..., n_trades, 8)`` trade log into one trader's buys and
    sells and the others' rows, ``trader_id`` of shape ``(...)`` (ref:
    common.py:99-122).  The API of the reference's trade-log workflow: the
    rewards read :class:`TradeSummary` sums (:func:`summarize_trades`, or
    the book scan's) and never scan the log."""
    trader_id = torch.as_tensor(trader_id, device=trades.device)[..., None]
    executed = torch.where((trades[..., TradeCol.PRICE] >= 0)[..., None],
                           trades, 0)
    mine = ((trader_id == executed[..., TradeCol.PASS_TID])
            | (trader_id == executed[..., TradeCol.AGR_TID]))
    agent_trades = torch.where(mine[..., None], executed, 0)
    other_trades = torch.where(mine[..., None], 0, executed)
    q = agent_trades[..., TradeCol.QUANT]
    is_pass = trader_id == agent_trades[..., TradeCol.PASS_TID]
    is_agr = trader_id == agent_trades[..., TradeCol.AGR_TID]
    # q > 0: a passive buy filled or an aggressive sell
    mask_buy = ((q >= 0) & is_pass) | ((q < 0) & is_agr)
    mask_sell = ((q < 0) & is_pass) | ((q >= 0) & is_agr)
    agent_buys = torch.where(mask_buy[..., None], agent_trades, 0)
    agent_sells = torch.where(mask_sell[..., None], agent_trades, 0)
    buy_quant = agent_buys[..., 1].abs().sum(dim=-1, dtype=trades.dtype)
    sell_quant = agent_sells[..., 1].abs().sum(dim=-1, dtype=trades.dtype)
    return TradeStats(agent_trades, other_trades, agent_buys, agent_sells,
                      buy_quant, sell_quant, buy_quant + sell_quant,
                      buy_quant - sell_quant)


def summarize_trades(trades: Tensor, trader_id: Tensor, tick: int
                     ) -> TradeSummary:
    """:class:`TradeSummary` from ``(..., n_trades, 8)`` trade logs for one
    trader id each, ``trader_id`` of shape ``(...)``.  The ``debug_mode``
    step reads its rewards' sums from the trade log through this; the main
    path takes them from the book scan."""
    executed = torch.where((trades[..., TradeCol.PRICE] >= 0)[..., None],
                           trades, 0)
    q_signed = executed[..., TradeCol.QUANT]
    q = q_signed.abs()
    p = executed[..., TradeCol.PRICE]
    tid = trader_id[..., None]
    is_pass = tid == executed[..., TradeCol.PASS_TID]
    is_agr = tid == executed[..., TradeCol.AGR_TID]
    mine = is_pass | is_agr
    mask_buy = mine & (((q_signed >= 0) & is_pass) | ((q_signed < 0) & is_agr))
    mask_sell = mine & (((q_signed < 0) & is_pass)
                        | ((q_signed >= 0) & is_agr))
    pt = torch.div(p, tick, rounding_mode="floor")

    def msum(mask, v):
        return torch.where(mask, v, 0).sum(dim=-1, dtype=torch.int32)

    return TradeSummary(
        buy_quant=msum(mask_buy, q), sell_quant=msum(mask_sell, q),
        buy_pq_tick=msum(mask_buy, pt * q),
        sell_pq_tick=msum(mask_sell, pt * q),
        agent_quant_abs=msum(mine, q), agent_pq_tick=msum(mine, pt * q),
        dur_wsum=msum(mine, executed[..., TradeCol.PASS_TID] * q),
        signed_sum=msum(mine, q_signed),
        total_quant=q.sum(dim=-1, dtype=torch.int32),
        total_pq_tick=(pt * q).sum(dim=-1, dtype=torch.int32))


def summary_from_aggs(per_agent: Tensor, totals: Tensor) -> TradeSummary:
    """TradeSummary from the book scan's sums.

    ``per_agent`` holds the 8 per-trader stats in the scan's bump order,
    which is TradeSummary field order, on its last axis; ``totals`` holds
    (total_quant, total_pq_tick).  Leading axes pass through.  This
    positional correspondence is the contract between the scan and
    TradeSummary (ref: common.py:210-222).
    """
    parts = [per_agent[..., i] for i in range(per_agent.shape[-1])]
    return TradeSummary(*parts, totals[..., 0], totals[..., 1])


def summary_add_trade(s: TradeSummary, enabled: Tensor, trader_id: Tensor,
                      price: Tensor, quant_signed: Tensor, pass_tid: int,
                      agr_tid: Tensor, tick: int) -> TradeSummary:
    """Fold one artificial trade (the episode-end unwind or doom trade) into
    a summary where ``enabled`` (ref: common.py:225-262)."""
    price = price.to(torch.int32)
    quant_signed = quant_signed.to(torch.int32)
    q = quant_signed.abs()
    is_pass = trader_id == pass_tid
    is_agr = trader_id == agr_tid
    mine = is_pass | is_agr
    is_buy = mine & (((quant_signed >= 0) & is_pass)
                     | ((quant_signed < 0) & is_agr))
    is_sell = mine & (((quant_signed < 0) & is_pass)
                      | ((quant_signed >= 0) & is_agr))
    pt = torch.div(price, tick, rounding_mode="floor")

    def add(cur, cond, v):
        return cur + torch.where(enabled & cond, v, 0)

    return TradeSummary(
        buy_quant=add(s.buy_quant, is_buy, q),
        sell_quant=add(s.sell_quant, is_sell, q),
        buy_pq_tick=add(s.buy_pq_tick, is_buy, pt * q),
        sell_pq_tick=add(s.sell_pq_tick, is_sell, pt * q),
        agent_quant_abs=add(s.agent_quant_abs, mine, q),
        agent_pq_tick=add(s.agent_pq_tick, mine, pt * q),
        dur_wsum=add(s.dur_wsum, mine, pass_tid * q),
        signed_sum=add(s.signed_sum, mine, quant_signed),
        total_quant=add(s.total_quant, torch.ones_like(mine), q),
        total_pq_tick=add(s.total_pq_tick, torch.ones_like(mine), pt * q),
    )


def mul_add(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 ``a + b * c`` with one rounding, as a fused multiply-add.

    The reward terms below subtract two money sums of ~1e5 ticks that
    nearly cancel; rounding ``b * c`` to float32 first moves the difference
    by ~1e-3 relative.  The JAX package's XLA CPU backend fuses these into
    FMAs; the port computes them the same way on every device (float64 is
    exact for the product of a float32 and a small integer).
    """
    a, b, c = (_f64(v) for v in (a, b, c))
    return (a + b * c).float()


def _f64(v) -> Tensor:
    """float64 of a tensor, or of a Python number taken as float32 first
    (a JAX weak-typed scalar meets float32 arrays as float32)."""
    if isinstance(v, Tensor):
        return v.double()
    return torch.tensor(v, dtype=torch.float32).double()


def mul_sub(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 ``a - b * c`` with one rounding (see :func:`mul_add`)."""
    a, b, c = (_f64(v) for v in (a, b, c))
    return (a - b * c).float()


def to_int32(x: Tensor) -> Tensor:
    """float -> int32 as XLA converts: toward zero, saturating at the int32
    range, NaN to 0 (a plain cast leaves NaN and out-of-range values
    undefined)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 31)
    big = x >= 2.0 ** 31
    x = torch.where(big, 0.0, torch.clamp(x, min=-2.0 ** 31))
    return torch.where(big, torch.iinfo(torch.int32).max,
                       x.to(torch.int32))


def sum_last(x: Tensor) -> Tensor:
    """float32 sum over the last axis in the order of the JAX package's
    XLA CPU backend: an axis longer than 32 is padded with zeros, equally
    on both sides, to windows of 32; each window is summed in order, then
    the window sums in order.

    XLA also turns a division by a constant into a product with its
    float32 reciprocal and folds constant factors together, so a mean
    divided by the tick is ``sum * (f32(1/n) * f32(1/tick))``.  Money
    terms that subtract such a mean from a nearly equal sum (the market
    maker's ``averageMidprice``, mm.py:315) move by ~1e-3 relative with
    another order or rounding.
    """
    def in_order(v):
        s = v[..., 0]
        for k in range(1, v.shape[-1]):
            s = s + v[..., k]
        return s

    n = x.shape[-1]
    x = x.to(torch.float32)
    if n > 32:
        w = -(-n // 32)
        pad = 32 * w - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = in_order(x.reshape(x.shape[:-1] + (w, 32)))
    return in_order(x)


def f32_product(*factors: float) -> Tensor:
    """The float32 product of float32 constants, as XLA folds them."""
    out = torch.tensor(1.0, dtype=torch.float32)
    for f in factors:
        out = out * torch.tensor(f, dtype=torch.float32)
    return out


def add_artificial_trade(wcfg, trades: Tensor, price, quant, time,
                         trader_id) -> Tensor:
    """The episode-end unwind or doom trade written into a ``(...,
    n_trades, 8)`` log (ref: common.py:271-286): ``[price, quant,
    artificial id, placeholder id, time_s, time_ns, artificial id,
    trader_id]`` over the first empty row, or the last row when none is
    empty.  As the JAX function: where some field is -1 but no row is
    empty, row 0.  ``price``, ``quant``, ``trader_id`` of shape ``(...)``,
    ``time`` ``(..., 2)``.  The rewards take the same trade through
    :func:`summary_add_trade`."""
    dev = trades.device
    lead = trades.shape[:-2]
    col = lambda v: torch.as_tensor(v, device=dev).to(  # noqa: E731
        torch.int32).expand(lead)
    time = torch.as_tensor(time, device=dev).to(torch.int32).expand(
        lead + (2,))
    row = torch.stack([col(price), col(quant),
                       col(wcfg.artificial_id_end_episode),
                       col(wcfg.placeholder_order_id), time[..., 0],
                       time[..., 1], col(wcfg.artificial_id_end_episode),
                       col(trader_id)], dim=-1).to(trades.dtype)
    empty = trades == -1
    first_empty = torch.where(
        empty.flatten(-2).any(dim=-1),
        empty.all(dim=-1).to(torch.int8).argmax(dim=-1),
        trades.shape[-2] - 1)
    at = torch.arange(trades.shape[-2], device=dev) == first_empty[..., None]
    return torch.where(at[..., None], row[..., None, :], trades)


def rolling_mean(avg: Tensor, new: Tensor, step_counter: Tensor) -> Tensor:
    """``(avg * n + new) / (n + 1)`` (ref: common.py:289-291), the product
    and sum rounded once as the JAX package's XLA fuses them
    (:func:`mul_add`)."""
    return mul_add(new, avg, step_counter) / (step_counter + 1)


def floor_tick(x: Tensor, tick: int) -> Tensor:
    """Floor a price to the tick grid (the reference's ``// tick * tick``)."""
    return torch.div(x, tick, rounding_mode="floor") * tick


def build_action_msgs(types: Tensor, sides: Tensor, quants: Tensor,
                      prices: Tensor, order_ids, trader_ids: Tensor,
                      time: Tensor, time_delay: Tensor) -> Tensor:
    """Stack per-message columns into ``(E, n, k, 8)`` int32 messages with
    the agent's (possibly delayed) timestamps.  Columns are ``(E, n, k)``
    (or broadcastable), ``time`` is ``(E, 2)``, ``time_delay`` ``(n,)``."""
    shape = torch.broadcast_shapes(types.shape, sides.shape, quants.shape,
                                   prices.shape, trader_ids.shape)
    t = (time[:, None, :] + time_delay[None, :, None]).to(torch.int32)
    cols = [types, sides, quants, prices,
            const(order_ids, torch.int32, time.device), trader_ids,
            t[:, :, None, 0], t[:, :, None, 1]]
    return torch.stack([c.to(torch.int32).expand(shape) for c in cols],
                       dim=-1)


def normalize_obs_dict(obs: Dict[str, Tensor], means: Dict[str, object],
                       stds: Dict[str, object]) -> Dict[str, Tensor]:
    """``(obs - mean) / std`` entry by entry (ref: common.py:306-307)."""
    return {k: (v - means[k]) / stds[k] for k, v in obs.items()}


def flatten_obs_dict(obs: Dict[str, Tensor]) -> Tensor:
    """Dict -> ``(..., k)`` float32, keys in sorted order: ``ravel_pytree``
    orders dict keys alphabetically and the reference relies on it
    (mm_env.py:2704-2706)."""
    return torch.stack([obs[k].to(torch.float32) for k in sorted(obs)],
                       dim=-1)
