"""Market-making agent: action builders, rewards, observations.

Port of ``vit_marl_tpu/env/mm.py``, batched: world leaves are ``(E, ...)``,
agent leaves ``(E, n, ...)`` for ``n`` instances of the type.

- actions: ``fixed_quants`` (8, with ``sell_buy_all_option``), ``simple``
  (3 or 4 with ``simple_nothing_action``, ``fixed_action_setting``),
  ``AvSt`` (Avellaneda-Stoikov, 8 risk aversions), ``spread_skew`` (6,
  ``multiplier_type`` ``tick`` or ``spread``), ``directional_trading``
  (3) and ``fixed_prices`` (a ``Box`` of ``n_actions`` quantities, one a
  price level);
- rewards: every entry of the reference's table (``zero_inv``, ``pnl``,
  ``buy_sell_pnl``, ``complex``, ``portfolio_value(_scaled)``,
  ``spooner(_damped/_scaled)``, ``delta_netWorth``,
  ``weight_pnl_inventory_pnl``), inventory penalties ``none``,
  ``linear``, ``quadratic``, ``threshold``, the portfolio reference
  prices ``mid``, ``best_bid_ask``, ``near_touch``, ``clip_reward`` and
  ``exclude_extreme_spreads``;
- observations: ``engineered`` (10, or 12 in ``fixed_time`` episodes),
  ``basic`` (1), ``messages`` (the world's combined ``(M, 8)`` int32
  stream) and ``messages_tokenized`` (``data/tokenizer.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vit_marl_tpu_torch.config import MarketMakingConfig, WorldConfig
from vit_marl_tpu_torch.env import common, spaces
from vit_marl_tpu_torch.env.structs import (
    Info,
    MMParams,
    MMState,
    Stream,
    WorldState,
)
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.utils.device import const

Tensor = torch.Tensor

_ACTIONS = ("fixed_quants", "simple", "AvSt", "spread_skew",
            "directional_trading", "fixed_prices")
_OBS = ("engineered", "basic", "messages", "messages_tokenized")
_REWARDS = ("portfolio_value", "portfolio_value_scaled", "pnl",
            "buy_sell_pnl", "complex", "zero_inv", "spooner",
            "spooner_damped", "spooner_scaled", "delta_netWorth",
            "weight_pnl_inventory_pnl")
# Avellaneda-Stoikov risk aversion per action (ref: mm.py:169)
_AVST_GAMMA = (0.1, 0.2, 0.5, 1, 2, 5, 10, 20)


class MarketMakingAgent:
    def __init__(self, cfg: MarketMakingConfig, wcfg: WorldConfig):
        for what, value, allowed in (
                ("action_space", cfg.action_space, _ACTIONS),
                ("observation_space", cfg.observation_space, _OBS),
                ("reward_space", cfg.reward_space, _REWARDS),
                ("inv_penalty", cfg.inv_penalty,
                 ("none", "linear", "quadratic", "threshold"))):
            if value not in allowed:
                raise ValueError(f"invalid MM {what} {value!r}")
        self.cfg = cfg
        self.wcfg = wcfg
        # rows of the message-stream observation: the world's combined
        # stream, set by the world (ref: mm.py:606-612)
        self.total_msgs_per_step = (cfg.num_messages
                                    + wcfg.n_data_msg_per_step)

    @property
    def needs_stream(self) -> bool:
        """Whether the observation reads the step's message stream."""
        return self.cfg.observation_space in ("messages",
                                              "messages_tokenized")

    def default_params(self, trader_id_start: int, n_agents: int,
                       device) -> Tuple[MMParams, int]:
        """(ref: mm_env.py:178-193)"""
        next_start = trader_id_start - n_agents
        full = lambda v: torch.full((n_agents,), v, device=device)  # noqa: E731
        params = MMParams(
            trader_id=torch.arange(trader_id_start, next_start, -1,
                                   dtype=torch.int32, device=device),
            time_delay_obs_act=full(self.cfg.time_delay_obs_act).int(),
            normalize=full(self.cfg.normalize).bool())
        return params, next_start

    def reset(self, params: MMParams, draw, world: WorldState
              ) -> Tuple[Tensor, MMState]:
        """(ref: mm_env.py:407-448); ``draw`` is unused (no randomness).
        A message-stream observation starts from a blank stream and the
        book at reset."""
        E, n = world.step_counter.shape[0], params.trader_id.shape[0]
        dev = world.step_counter.device
        state = MMState(
            inventory=torch.zeros((E, n), dtype=torch.int32, device=dev),
            total_PnL=torch.zeros((E, n), device=dev),
            cash_balance=torch.zeros((E, n), device=dev))
        stream = None
        if self.needs_stream:
            stream = Stream(
                msgs=torch.zeros((E, self.total_msgs_per_step, 8),
                                 dtype=torch.int32, device=dev),
                old_mid=world.mid_price,
                lob_before=bk.get_l2_state(self.wcfg, 10, world.books))
        return self.get_observation(world, state, stream), state

    def draw_reset(self, n_envs: int, generator: torch.Generator):
        return None

    def draw_step(self, n_envs: int, n: int, generator: torch.Generator):
        return None

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------

    def _tick_best(self, world: WorldState) -> Tuple[Tensor, Tensor]:
        """Tick-floored best ask and bid, ``(E, 1)`` int32."""
        tick = self.wcfg.tick_size
        return (common.floor_tick(world.best_asks[:, -1, 0], tick)[:, None],
                common.floor_tick(world.best_bids[:, -1, 0], tick)[:, None])

    def _two_msgs(self, world: WorldState, params: MMParams,
                  bid_quant: Tensor, ask_quant: Tensor, bid_price: Tensor,
                  ask_price: Tensor) -> Tensor:
        """A bid and an ask, ``(E, n, 2, 8)``."""
        dev = world.step_counter.device
        q = torch.stack(torch.broadcast_tensors(bid_quant, ask_quant), -1)
        p = torch.stack(torch.broadcast_tensors(bid_price, ask_price), -1)
        return common.build_action_msgs(
            types=torch.ones(2, dtype=torch.int32, device=dev),
            sides=const([1, -1], torch.int32, dev),
            quants=q.to(torch.int32), prices=p.to(torch.int32),
            order_ids=self.wcfg.placeholder_order_id,
            trader_ids=params.trader_id[None, :, None],
            time=world.time, time_delay=params.time_delay_obs_act)

    def _table(self, values, action: Tensor, dtype=torch.float32) -> Tensor:
        return const(values, dtype, action.device)[action.long()]

    def _action_fixed_quants(self, action, world, state, params):
        """(ref: mm_env.py:959-1037)"""
        tick = self.wcfg.tick_size
        best_ask, best_bid = self._tick_best(world)
        fq = self.cfg.fixed_quant_value
        if not self.cfg.sell_buy_all_option:
            bid_off = self._table([0, 2, 4, -1, 0, 2, 5, -1], action)
            ask_off = self._table([0, 2, 4, -1, 2, 0, -1, 5], action)
            bid_q = self._table([0, 1, 1, 1, 1, 1, 1, 1], action, torch.int32)
            ask_q = self._table([0, 1, 1, 1, 1, 1, 1, 1], action, torch.int32)
        else:
            all_q = torch.div(state.inventory, fq, rounding_mode="floor")
            bid_off = self._table([0, 2, 4, -1, 0, 2, -20, 0], action)
            ask_off = self._table([0, 2, 4, -1, 2, 0, 0, -20], action)
            bid_q = torch.where(action == 6, all_q, self._table(
                [0, 1, 1, 1, 1, 1, 0, 0], action, torch.int32))
            ask_q = torch.where(action == 7, all_q, self._table(
                [0, 1, 1, 1, 1, 1, 0, 0], action, torch.int32))
        tick_offset = self.cfg.n_ticks_in_book * tick
        bid_price = best_bid - bid_off * tick_offset
        ask_price = best_ask + ask_off * tick_offset
        bid_price = common.floor_tick(torch.clamp(bid_price, min=0), tick
                                      ).to(torch.int32)
        ask_price = common.floor_tick(
            torch.maximum(bid_price + tick, ask_price), tick).to(torch.int32)
        return self._two_msgs(world, params, bid_q * fq, ask_q * fq,
                              bid_price, ask_price)

    def _action_simple(self, action, world, state, params):
        """(ref: mm_env.py:1042-1161)"""
        cfg = self.cfg
        tick = self.wcfg.tick_size
        best_ask, best_bid = self._tick_best(world)
        fq = cfg.fixed_quant_value
        if cfg.fixed_action_setting:
            action = torch.full_like(action, cfg.fixed_action)
        bid_off = self._table([0, -2000, 0, 0], action)
        ask_off = self._table([0, 0, -2000, 0], action)
        if not cfg.sell_buy_all_option:
            bid_q = self._table([1, 1, 0, 0], action, torch.int32) * fq
            ask_q = self._table([1, 0, 1, 0], action, torch.int32) * fq
        else:
            inv = state.inventory
            big = torch.clamp(inv.abs(), min=fq)
            fq_t = torch.full_like(inv, fq)
            a_q = torch.where(inv > 0, big, fq_t)
            b_q = torch.where(inv > 0, fq_t, big)
            base = self._table([fq, 0, 0, 0], action, torch.int32)
            bid_q = torch.where(action == 1, b_q, base)
            ask_q = torch.where(action == 2, a_q, base)
        tick_offset = cfg.n_ticks_in_book * tick
        bid_price = best_bid - bid_off * tick_offset
        ask_price = best_ask + ask_off * tick_offset
        bid_price = common.floor_tick(torch.clamp(bid_price, min=0), tick
                                      ).to(torch.int32)
        ask_price = common.floor_tick(ask_price, tick).to(torch.int32)
        return self._two_msgs(world, params, bid_q, ask_q, bid_price,
                              ask_price)

    def _action_avst(self, action, world, state, params):
        """Avellaneda-Stoikov quotes (ref: mm_env.py:1166-1244).  As the
        reference, ``k`` reads the trade log's capacity as the order count
        and the volatility takes the std of the (price, quantity) rows of
        the last 100 best quotes."""
        wcfg = self.wcfg
        tick = wcfg.tick_size
        best_ask, best_bid = self._tick_best(world)
        mid_price = torch.div(best_ask + best_bid, 2, rounding_mode="floor")
        gamma = self._table(_AVST_GAMMA, action)
        k = (wcfg.n_trades / world.delta_time + 0.1)[:, None]
        mid_hist = (world.best_asks[:, -100:] + world.best_bids[:, -100:]) / 2
        returns = torch.log(mid_hist[:, 1:] / mid_hist[:, :-1])
        vol = torch.clamp(returns.std(dim=(1, 2), correction=0), 0.001, 0.2)
        variance = (vol ** 2)[:, None]
        time_left = wcfg.episode_time - (world.time - world.init_time)[:, 0]
        norm_t = (time_left / wcfg.episode_time)[:, None]
        res_price = common.mul_sub(mid_price, state.inventory * gamma
                                   * variance, norm_t)
        spread = (common.mul_add((2 / gamma) * torch.log(1 + gamma / k),
                                 gamma * variance, norm_t)) * tick
        spread = torch.clamp(spread, tick, wcfg.maxint)
        bid_price = torch.clamp(res_price - spread, 0, wcfg.maxint)
        ask_price = torch.clamp(res_price + spread, 0, wcfg.maxint)
        bid_price = common.to_int32(common.floor_tick(bid_price, tick))
        ask_price = common.to_int32(common.floor_tick(ask_price, tick))
        fq = torch.full_like(bid_price, self.cfg.fixed_quant_value)
        return self._two_msgs(world, params, fq, fq, bid_price, ask_price)

    def _action_spread_skew(self, action, world, state, params):
        """(ref: mm_env.py:1352-1491)"""
        tick = self.wcfg.tick_size
        best_ask, best_bid = self._tick_best(world)
        mid_price = (best_ask + best_bid) / 2
        current_spread = best_ask - best_bid
        spread_type = torch.div(action, 3, rounding_mode="floor")
        skew_type = action % 3
        one = torch.ones((), device=action.device)
        spread_multiplier = torch.where(spread_type == 0, one,
                                        one * self.cfg.spread_multiplier)
        new_spread = current_spread * spread_multiplier
        sk = float(self.cfg.skew_multiplier)
        skew_ticks = torch.where(skew_type == 0, -sk * one,
                                 torch.where(skew_type == 1, 0 * one,
                                             sk * one))
        if self.cfg.multiplier_type == "spread":
            skewed_mid = mid_price + skew_ticks * new_spread
        else:
            skewed_mid = mid_price + skew_ticks * tick
        half = torch.div(new_spread, 2, rounding_mode="floor")
        bid_price = common.floor_tick(skewed_mid - half, tick).to(torch.int32)
        ask_price = common.floor_tick(skewed_mid + half, tick).to(torch.int32)
        fq = torch.full_like(bid_price, self.cfg.fixed_quant_value)
        return self._two_msgs(world, params, fq, fq, bid_price, ask_price)

    def _action_directional(self, action, world, state, params):
        """(ref: mm_env.py:1495-1550): a buy crosses at the best ask, a
        sell at the best bid."""
        best_ask, best_bid = self._tick_best(world)
        q = self.cfg.fixed_quant_value
        bid_q = self._table([0, 1, 0], action, torch.int32) * q
        ask_q = self._table([0, 0, 1], action, torch.int32) * q
        return self._two_msgs(world, params, bid_q, ask_q, best_ask,
                              best_bid)

    def _action_fixed_prices(self, action, world, state, params):
        """A quantity a price level, ``action`` ``(E, n, n_actions)``
        (ref: mm_env.py:1246-1350): buy levels then sell levels."""
        tick = self.wcfg.tick_size
        nt = self.cfg.n_ticks_in_book
        n = self.cfg.n_actions
        best_ask, best_bid = self._tick_best(world)
        mid = (torch.ceil(torch.div((best_bid + best_ask) / 2, tick,
                                    rounding_mode="floor"))
               * tick).to(torch.int32)
        buy = {4: [best_ask, mid, best_bid, best_bid - tick * nt],
               3: [best_bid + tick * nt, best_bid, best_bid - tick * nt],
               2: [best_bid, best_bid - tick * nt], 1: [best_bid]}[n // 2]
        sell = {4: [best_bid, mid, best_ask, best_ask + tick * nt],
                3: [best_ask - tick * nt, best_ask, best_ask + tick * nt],
                2: [best_ask, best_ask + tick * nt], 1: [best_ask]}[n // 2]
        prices = torch.stack(buy + sell, dim=-1).to(torch.int32)  # (E,1,n)
        dev = action.device
        sides = const([1] * (n // 2) + [-1] * (n // 2), torch.int32, dev)
        return common.build_action_msgs(
            types=torch.ones(n, dtype=torch.int32, device=dev), sides=sides,
            quants=action.to(torch.int32), prices=prices,
            order_ids=self.wcfg.placeholder_order_id,
            trader_ids=params.trader_id[None, :, None],
            time=world.time, time_delay=params.time_delay_obs_act)

    def get_action_msgs(self, action: Tensor, world: WorldState,
                        state: MMState, params: MMParams) -> Tensor:
        """The action's messages, ``(E, n, k, 8)`` (ref: mm.py:262-275)."""
        build = {
            "fixed_quants": self._action_fixed_quants,
            "simple": self._action_simple,
            "AvSt": self._action_avst,
            "spread_skew": self._action_spread_skew,
            "directional_trading": self._action_directional,
            "fixed_prices": self._action_fixed_prices,
        }[self.cfg.action_space]
        return build(action, world, state, params)

    def get_messages(self, action: Tensor, world: WorldState,
                     state: MMState, params: MMParams, draw=None
                     ) -> Tuple[Tensor, Tensor]:
        """Action and cancel messages, ``(E, n, k, 8)`` each
        (ref: mm_env.py:1554-1587)."""
        action_msgs = self.get_action_msgs(action, world, state, params)
        per_side = self.cfg.num_messages // 4
        tid = params.trader_id[None, :].expand(action.shape[0], -1)
        books = world.books
        cnl_bid = bk.make_cancel_msgs(books.bids, tid, per_side, 1,
                                      world.time[:, 0], world.time[:, 1])
        cnl_ask = bk.make_cancel_msgs(books.asks, tid, per_side, -1,
                                      world.time[:, 0], world.time[:, 1])
        cancel_msgs = torch.cat([cnl_bid, cnl_ask], dim=2)
        return common.filter_messages(action_msgs, cancel_msgs)

    # ------------------------------------------------------------------
    # reward
    # ------------------------------------------------------------------

    def _ep_is_over(self, world: WorldState, time: Tensor) -> Tensor:
        """``(E, 1)``: the step that ends the episode (ref: mm.py:309-313);
        ``time`` is the step's last message time."""
        wcfg = self.wcfg
        if wcfg.ep_type == "fixed_time":
            remaining = wcfg.episode_time - (time - world.init_time)[:, 0]
            return (remaining <= wcfg.last_step_seconds)[:, None]
        return (world.max_steps_in_episode - world.step_counter
                - 1 <= 1)[:, None]

    def _reference_price(self, inventory: Tensor, bids: Tensor,
                         asks: Tensor, mid: Tensor) -> Tensor:
        """Portfolio price in ticks (ref: mm.py:346-355, :406-415):
        ``bids``/``asks``/``mid`` are ``(E, 1)`` prices."""
        tick = self.wcfg.tick_size
        kind = self.cfg.reference_price_portfolio_value
        if kind == "mid":
            return mid / tick
        if kind == "best_bid_ask":
            return torch.where(inventory > 0, bids / tick, asks / tick)
        return torch.where(inventory > 0, asks / tick, bids / tick)

    def get_reward(self, world: WorldState, state: MMState, params: MMParams,
                   bestasks: Tensor, bestbids: Tensor,
                   summary: common.TradeSummary, time: Tensor
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The configured reward over the step's trade sums
        (ref: mm.py:293-481)."""
        cfg, wcfg = self.cfg, self.wcfg
        tick = wcfg.tick_size
        col = lambda v: v[:, None]                    # noqa: E731
        inv_before = state.inventory + summary.inventory_delta
        ep_is_over = self._ep_is_over(world, time)
        # averageMidprice (ref: mm.py:315), and over the tick, as the JAX
        # package's XLA backend sums and scales it (common.sum_last)
        average_mid = average_mid_tick = None
        if cfg.reward_space == "complex" or \
                not cfg.based_on_mid_price_of_action:
            M = bestbids.shape[1]
            mid_sum = col(common.sum_last(
                (bestbids[:, :, 0] + bestasks[:, :, 0]) / 2))
            average_mid = mid_sum * common.f32_product(1 / M)
            average_mid_tick = mid_sum * common.f32_product(1 / M, 1 / tick)
        last_mid = col((world.best_bids[:, -1, 0]
                        + world.best_asks[:, -1, 0]) / 2)
        if cfg.based_on_mid_price_of_action:
            mid_ref, buy_ref = last_mid, last_mid / tick
        else:
            mid_ref, buy_ref = average_mid, average_mid_tick
        if cfg.reference_price_portfolio_value == "mid":
            unwind_price = mid_ref.expand_as(inv_before).to(torch.int32)
        else:
            unwind_price = torch.where(
                inv_before > 0,
                common.floor_tick(col(bestbids[:, -1, 0]), tick),
                common.floor_tick(col(bestasks[:, -1, 0]), tick))
        tid = params.trader_id[None, :]
        st = common.summary_add_trade(
            summary, ep_is_over & (inv_before.abs() > 0), tid, unwind_price,
            (torch.sign(inv_before) * inv_before.abs()).to(torch.int32),
            pass_tid=wcfg.artificial_id_end_episode, agr_tid=tid, tick=tick)
        new_inventory = state.inventory + st.inventory_delta

        bid_end, ask_end = col(bestbids[:, -1, 0]), col(bestasks[:, -1, 0])
        mid_price_end = (bid_end + ask_end) / 2
        pnl = (st.sell_pq_tick - st.buy_pq_tick).to(torch.float32)
        reference_price = self._reference_price(new_inventory, bid_end,
                                                ask_end, mid_price_end)
        new_cash_balance = state.cash_balance + pnl
        inventory_value = new_inventory * reference_price
        inventory_pnl = (state.inventory * (mid_price_end
                                            - col(world.mid_price)) / tick)
        # money terms that nearly cancel: one rounding (common.mul_add)
        buy_pnl = common.mul_add(-st.buy_pq_tick, buy_ref, st.buy_quant)
        sell_pnl = common.mul_sub(st.sell_pq_tick, buy_ref, st.sell_quant)
        aggr_buy = common.mul_add(-st.buy_pq_tick, ask_end / tick,
                                  st.buy_quant)
        aggr_sell = common.mul_sub(st.sell_pq_tick, bid_end / tick,
                                   st.sell_quant)
        inv_pos = torch.clamp(inventory_pnl, min=0)
        reward_spooner = aggr_buy + aggr_sell + inventory_pnl - inv_pos
        reward_portfolio_value = common.mul_add(
            new_cash_balance, new_inventory, reference_price)

        space = cfg.reward_space
        lam = cfg.inventoryPnL_lambda
        if space in ("portfolio_value", "portfolio_value_scaled"):
            reward = reward_portfolio_value / (
                100 if space == "portfolio_value_scaled" else 1)
        elif space == "pnl":
            reward = pnl
        elif space == "buy_sell_pnl":
            reward = buy_pnl + sell_pnl
        elif space == "zero_inv":
            reward = -new_inventory.abs()
        elif space == "spooner":
            reward = reward_spooner
        elif space == "spooner_damped":
            reward = common.mul_sub(aggr_buy + aggr_sell + inventory_pnl,
                                    1 - lam, inv_pos)
        elif space == "spooner_scaled":
            inner = common.mul_sub(
                inventory_pnl, 1 - cfg.asymmetrically_dampened_lambda,
                inv_pos)
            reward = common.mul_add(aggr_buy + aggr_sell, lam, inner) / 10
        elif space == "weight_pnl_inventory_pnl":
            reward = common.mul_add(buy_pnl + sell_pnl, lam, inventory_pnl)
        elif space == "complex":
            reward = self._reward_complex(st, inventory_pnl,
                                          average_mid_tick)
        else:   # delta_netWorth
            net_worth = common.mul_add(new_cash_balance, new_inventory,
                                       reference_price)
            old_ref = self._reference_price(
                state.inventory, col(world.best_bids[:, -1, 0]),
                col(world.best_asks[:, -1, 0]), col(world.mid_price))
            old_net_worth = common.mul_add(state.cash_balance, old_ref,
                                           state.inventory)
            reward = net_worth - old_net_worth

        reward = reward.to(torch.float32)
        if cfg.inv_penalty != "none":
            inv = new_inventory
            pen = {"linear": lambda: -inv.abs(),
                   "quadratic": lambda: -(inv ** 2)
                   / cfg.inv_penalty_quadratic_factor,
                   "threshold": lambda: torch.where(
                       inv.abs() > 50, -1.0 * (inv ** 2), 0.0)}[
                           cfg.inv_penalty]()
            reward = common.mul_add(reward, cfg.inv_penalty_lambda, pen)
        if cfg.clip_reward:
            reward = torch.clamp(reward, -10_000, 10_000)
        if cfg.exclude_extreme_spreads:
            ask, bid = world.best_asks[:, :, 0], world.best_bids[:, :, 0]
            ratio = (ask - bid) / ((ask + bid) / 2)
            reward = torch.where(col((ratio > 0.1).any(dim=1)), 0.0, reward)
        extras = {
            "reward": reward,
            "reward_portfolio_value": reward_portfolio_value,
            "reward_spooner": reward_spooner,
            "inventoryValue": inventory_value,
            "buyPnL": buy_pnl,
            "sellPnL": sell_pnl,
            "PnL": pnl,
            "cash_balance": new_cash_balance,
            "end_inventory": new_inventory,
        }
        return reward, extras

    def _reward_complex(self, st: common.TradeSummary, inventory_pnl: Tensor,
                        average_mid_tick: Tensor) -> Tensor:
        """Approximate realized + unrealized PnL (ref: mm.py:385-402);
        ``average_mid_tick``: the step's average mid price in ticks."""
        cfg = self.cfg
        avg_buy = torch.where(st.buy_quant > 0, st.buy_pq_tick
                              / torch.clamp(st.buy_quant, min=1), 0.0)
        avg_sell = torch.where(st.sell_quant > 0, st.sell_pq_tick
                               / torch.clamp(st.sell_quant, min=1), 0.0)
        realized = torch.minimum(st.buy_quant, st.sell_quant) * (
            avg_sell - avg_buy)
        delta = st.inventory_delta
        unrealized = torch.where(delta > 0,
                                 delta * (average_mid_tick - avg_buy),
                                 delta.abs() * (avg_sell - average_mid_tick))
        damped = torch.minimum(inventory_pnl, inventory_pnl
                               * cfg.asymmetrically_dampened_lambda)
        return common.mul_add(
            common.mul_add(realized, cfg.unrealizedPnL_lambda, unrealized),
            cfg.inventoryPnL_lambda, damped)

    def is_terminal(self, world: WorldState) -> Tensor:
        """``(E,)`` (ref: mm.py:487-492)"""
        if self.wcfg.ep_type == "fixed_time":
            time_left = self.wcfg.episode_time - (world.time
                                                  - world.init_time)[:, 0]
            return time_left <= self.cfg.seconds_before_episode_end
        return world.max_steps_in_episode - world.step_counter <= 1

    def update_state(self, world: WorldState, state: MMState, extras
                     ) -> Tuple[MMState, Tensor, Info]:
        """(ref: mm_env.py:2302-2348)"""
        new_state = MMState(inventory=extras["end_inventory"],
                            total_PnL=state.total_PnL + extras["PnL"],
                            cash_balance=extras["cash_balance"])
        done = self.is_terminal(world)[:, None].expand_as(state.inventory)
        info = Info({
            "reward": extras["reward"],
            "reward_portfolio_value": extras["reward_portfolio_value"],
            "reward_spooner": extras["reward_spooner"],
            "total_PnL": new_state.total_PnL,
            "done": done,
            "inventory": new_state.inventory,
            "buyPnL": extras["buyPnL"],
            "sellPnL": extras["sellPnL"],
            "inventoryValue": extras["inventoryValue"],
        })
        return new_state, done, info

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def get_observation(self, world: WorldState, state: MMState,
                        stream: Optional[Stream] = None) -> Tensor:
        """``(E, n, d)`` float32, or the int32 message stream ``(E, n, M,
        8)`` / tokens ``(E, n, 13 M + 84)`` (ref: mm.py:561-585).
        ``stream``: the step's combined messages with the mid price and
        the L2 book before it, for the message observations."""
        o = self.cfg.observation_space
        if o == "engineered":
            return self._obs_engineered(world, state)
        if o == "basic":
            obs = {"inventory": state.inventory}
            if self.cfg.normalize:
                obs = common.normalize_obs_dict(obs, {"inventory": 0},
                                                {"inventory": 10})
            return common.flatten_obs_dict(obs)
        n = state.inventory.shape[1]
        if o == "messages":
            out = stream.msgs
        else:
            from vit_marl_tpu_torch.data.tokenizer import (
                DEFAULT_TOKENIZER,
                tokenize_observation,
            )
            out = tokenize_observation(
                DEFAULT_TOKENIZER, stream.msgs, world.best_bids,
                world.best_asks, stream.old_mid, stream.lob_before,
                world.time)
        return out[:, None].expand((-1, n) + tuple(out.shape[1:]))

    def _obs_engineered(self, world: WorldState, state: MMState) -> Tensor:
        """10 engineered features, 12 in ``fixed_time`` episodes
        (ref: mm.py:519-550)."""
        shape = state.inventory.shape
        w = lambda v: v[:, None].expand(shape)        # noqa: E731
        obs = {
            "p_bid": w(world.best_bids[:, -1, 0]),
            "p_ask": w(world.best_asks[:, -1, 0]),
            "spread": w((world.best_asks[:, -1, 0]
                         - world.best_bids[:, -1, 0]).abs()),
            "q_bid": w(world.best_bids[:, -1, 1]),
            "q_ask": w(world.best_asks[:, -1, 1]),
            "mid_price": w(world.mid_price),
            "step_counter": w(world.step_counter),
            "total_PnL": state.total_PnL,
            "cash_balance": state.cash_balance,
            "inventory": state.inventory,
        }
        stds = {
            "p_bid": 1e7, "p_ask": 1e7, "spread": 1e4, "q_bid": 100,
            "q_ask": 100, "mid_price": 1e7, "step_counter": 10,
            "total_PnL": 1000, "cash_balance": 1000, "inventory": 10,
        }
        if self.wcfg.ep_type == "fixed_time":
            t = world.time[:, 0] + world.time[:, 1] / 1e9
            elapsed = t - (world.init_time[:, 0]
                           + world.init_time[:, 1] / 1e9)
            obs["delta_time"] = w(world.delta_time)
            obs["time_remaining"] = w(self.wcfg.episode_time - elapsed)
            stds.update(delta_time=10, time_remaining=self.wcfg.episode_time)
        if self.cfg.normalize:
            obs = common.normalize_obs_dict(obs, dict.fromkeys(obs, 0), stds)
        return common.flatten_obs_dict(obs)

    # ------------------------------------------------------------------
    # spaces
    # ------------------------------------------------------------------

    def action_space(self):
        """(ref: mm.py:591-604)"""
        a = self.cfg.action_space
        if a == "directional_trading":
            return spaces.Discrete(3)
        if a == "fixed_prices":
            return spaces.Box(0, 100, (self.cfg.n_actions,), torch.int32)
        if a in ("fixed_quants", "AvSt"):
            return spaces.Discrete(8)
        if a == "spread_skew":
            return spaces.Discrete(6)
        return spaces.Discrete(4 if self.cfg.simple_nothing_action else 3)

    def observation_space(self):
        """(ref: mm.py:614-631)"""
        o = self.cfg.observation_space
        n = self.total_msgs_per_step
        if o == "engineered":
            dim = 12 if self.wcfg.ep_type == "fixed_time" else 10
            return spaces.Box(-1000, 1000, (dim,))
        if o == "basic":
            return spaces.Box(-10_000, 10_000, (1,))
        if o == "messages":
            return spaces.Box(-self.wcfg.maxint, self.wcfg.maxint, (n, 8),
                              torch.int32)
        from vit_marl_tpu_torch.data.tokenizer import DEFAULT_TOKENIZER
        return spaces.Box(0, DEFAULT_TOKENIZER.TOTAL_NUM_TOKENS - 1,
                          (n * 13 + 84,), torch.int32)
