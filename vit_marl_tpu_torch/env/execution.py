"""Execution agent: optimal-execution action, reward and observation
spaces.

Port of ``vit_marl_tpu/env/execution.py``, batched over ``(E, n)``:

- actions ``fixed_quants`` (5), ``fixed_quants_complex`` (13),
  ``fixed_quants_1msg`` (5, one message), ``simplest_case`` (3: no trade,
  far touch, near touch), ``fixed_prices`` (a ``Box`` of ``n_actions``
  quantities over a ladder of the last 10 best quotes, ``action_type``
  ``pure`` or ``delta`` over the ``twap_v3`` split, capped at the task by
  Hamilton apportionment), the baselines ``twap`` and ``twap_v3``, and
  ``policy_blending`` (continuous ``Box(3,)`` blend over the top-3
  own-side levels, with the ``blend_aggressive`` option);
- rewards ``normal``, ``finish_fast``, ``simplest_case`` and ``dual_ppo``;
- observations ``engineered`` (12, 15 in ``fixed_time`` episodes),
  ``basic`` (3), ``simplest_case`` (3) and ``execution_policy`` (28), and
  the ``{"obs", "vision_obs"}`` dict with the normalized ``(levels, 3,
  2)`` book image when ``use_vision_obs`` is set.

``twap_v3`` and ``fixed_prices`` draw each step (the split's order, the
apportionment's tie-breaks); the draws enter as
:class:`~vit_marl_tpu_torch.env.structs.ExecStepDraw`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vit_marl_tpu_torch.config import ExecutionConfig, WorldConfig
from vit_marl_tpu_torch.env import common, spaces
from vit_marl_tpu_torch.env.structs import (
    ExecParams,
    ExecState,
    ExecStepDraw,
    Info,
    WorldState,
)
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.utils.device import const
from vit_marl_tpu_torch.utils.ints import hamilton_apportionment_permuted

Tensor = torch.Tensor

# 13 actions: 4 levels x {1, 2, 5} x quant + no trade (vision_env.py:1046)
_QUANT_ARRAY = [
    [0, 0, 0, 0],
    [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
    [2, 0, 0, 0], [0, 2, 0, 0], [0, 0, 2, 0], [0, 0, 0, 2],
    [5, 0, 0, 0], [0, 5, 0, 0], [0, 0, 5, 0], [0, 0, 0, 5]]
_ACTIONS = ("fixed_quants", "fixed_quants_complex", "fixed_quants_1msg",
            "simplest_case", "fixed_prices", "twap", "twap_v3",
            "policy_blending")
_OBS = ("engineered", "basic", "simplest_case", "execution_policy")
_REWARDS = ("normal", "finish_fast", "simplest_case", "dual_ppo")
# fixed_prices ladder rows of (FT, M, NT, PP) per n_actions
# (ref: execution.py:211-213)
_LADDER_ROWS = {4: [0, 1, 2, 3], 3: [0, 2, 3], 2: [0, 2], 1: [0]}


class ExecutionAgent:
    def __init__(self, cfg: ExecutionConfig, wcfg: WorldConfig):
        for what, value, allowed in (
                ("action_space", cfg.action_space, _ACTIONS),
                ("observation_space", cfg.observation_space, _OBS),
                ("reward_space", cfg.reward_space, _REWARDS),
                ("task", cfg.task, ("random", "buy", "sell"))):
            if value not in allowed:
                raise ValueError(f"invalid execution {what} {value!r}")
        if cfg.action_space == "fixed_prices":
            if cfg.n_actions not in _LADDER_ROWS:
                raise ValueError("fixed_prices takes n_actions in 1-4, got "
                                 f"{cfg.n_actions}")
            if cfg.action_type == "delta" and cfg.n_actions != 2:
                # the twapV3 delta baseline is a 2-vector (FT, NT)
                # (ref: execution.py:44-48)
                raise ValueError("action_type='delta' requires n_actions=2 "
                                 "(FT, NT ladder)")
        if cfg.action_space == "twap" and wcfg.ep_type != "fixed_steps":
            # (ref: execution.py:289-290)
            raise ValueError("twap requires fixed_steps episodes")
        self.cfg = cfg
        self.wcfg = wcfg

    needs_stream = False

    def default_params(self, trader_id_start: int, n_agents: int,
                       device) -> Tuple[ExecParams, int]:
        """(ref: vision_env.py:184-199)"""
        next_start = trader_id_start - n_agents
        full = lambda v: torch.full((n_agents,), v, device=device)  # noqa: E731
        params = ExecParams(
            trader_id=torch.arange(trader_id_start, next_start, -1,
                                   dtype=torch.int32, device=device),
            task_size=full(self.cfg.task_size).int(),
            reward_lambda=full(self.cfg.reward_lambda).float(),
            time_delay_obs_act=full(self.cfg.time_delay_obs_act).int(),
            normalize=full(self.cfg.normalize).bool())
        return params, next_start

    def draw_reset(self, n_envs: int, generator: torch.Generator
                   ) -> Optional[Tensor]:
        """The task direction drawn at reset: ``(E,)`` in {0, 1}, shared by
        the instances of the type (ref: vision_env.py:420-477 draws one
        ``randint`` per type)."""
        if self.cfg.task != "random":
            return None
        return torch.randint(0, 2, (n_envs,), generator=generator,
                             device=generator.device, dtype=torch.int32)

    def reset(self, params: ExecParams, draw: Optional[Tensor],
              world: WorldState) -> Tuple[Tensor, ExecState]:
        """(ref: vision_env.py:420-477)"""
        E, n = world.step_counter.shape[0], params.trader_id.shape[0]
        dev = world.step_counter.device
        if self.cfg.task == "random":
            is_sell = draw.to(device=dev, dtype=torch.int32)
        else:
            is_sell = torch.full((E,), int(self.cfg.task == "sell"),
                                 dtype=torch.int32, device=dev)
        z = torch.zeros((E, n), device=dev)
        state = ExecState(
            init_price=world.mid_price[:, None].expand(E, n).clone(),
            task_to_execute=params.task_size[None, :].expand(E, n).clone(),
            quant_executed=torch.zeros((E, n), dtype=torch.int32, device=dev),
            total_revenue=z, drift_return=z, advantage_return=z,
            slippage_rm=z, price_adv_rm=z, price_drift_rm=z, vwap_rm=z,
            is_sell_task=is_sell[:, None].expand(E, n).clone(),
            trade_duration=z)
        return self.get_observation(world, state), state

    def draw_step(self, n_envs: int, n: int, generator: torch.Generator
                  ) -> Optional[ExecStepDraw]:
        """This step's draws of the ``n`` instances (ref: execution.py:
        230-285): the ``twap_v3`` split's order and the apportionment's
        tie-breaks; ``None`` for the spaces that draw nothing."""
        space = self.cfg.action_space
        twap = space == "twap_v3" or (space == "fixed_prices"
                                      and self.cfg.action_type == "delta")
        if space not in ("twap_v3", "fixed_prices"):
            return None
        k = 2 if space == "twap_v3" else self.cfg.n_actions
        dev = generator.device
        swap = (torch.rand((n_envs, n), generator=generator, device=dev)
                < 0.5) if twap else None
        ties = torch.rand((n_envs, n, k), generator=generator, device=dev)
        return ExecStepDraw(swap=swap, ties=ties)

    # ------------------------------------------------------------------

    def _ladder(self, best_ask: Tensor, best_bid: Tensor, state: ExecState
                ) -> Tensor:
        """(FT, M, NT, PP) for the task direction from ``(E, 1)`` best
        quotes, ``(E, n, 4)`` int32 (ref: execution.py:98-120)."""
        tick = self.wcfg.tick_size
        nt = self.cfg.n_ticks_in_book
        buy = torch.stack([
            best_ask,
            common.floor_tick(torch.div(best_bid + best_ask, 2,
                                        rounding_mode="floor"), tick),
            best_bid, best_bid - tick * nt], dim=-1)
        sell_mid = (torch.ceil(torch.div((best_bid + best_ask) / 2, tick,
                                         rounding_mode="floor"))
                    * tick).to(torch.int32)
        sell = torch.stack([best_bid, sell_mid, best_ask,
                            best_ask + tick * nt], dim=-1)
        is_sell = state.is_sell_task[..., None] != 0
        return torch.where(is_sell, sell, buy).to(torch.int32)

    def _task_prices(self, world: WorldState, state: ExecState) -> Tensor:
        """The ladder from the instantaneous best quotes."""
        tick = self.wcfg.tick_size
        return self._ladder(
            common.floor_tick(world.best_asks[:, -1, 0], tick)[:, None],
            common.floor_tick(world.best_bids[:, -1, 0], tick)[:, None],
            state)

    @staticmethod
    def _cap_quants(quants: Tensor, first_row: Tensor, state: ExecState
                    ) -> Tensor:
        """Quantities over the task's remainder become ``first_row *
        remainder`` (ref: execution.py:140-146, vision_env.py:906-913)."""
        quant_left = (state.task_to_execute - state.quant_executed)[..., None]
        return torch.where(quants.sum(dim=-1, keepdim=True) <= quant_left,
                           quants, first_row * quant_left).to(torch.int32)

    @staticmethod
    def _ft_nt(action: Tensor) -> Tensor:
        """The far- and near-touch columns (0 and 2) of the task prices."""
        return const([0, 2], torch.int64, action.device)

    def _quants_fixed_quants(self, action, world, state):
        """5 actions: no trade or one of 4 levels (ref: execution.py:
        152-162); ``larger_far_touch_quant`` sends 10x at the far touch."""
        row1 = [10, 0, 0, 0] if self.cfg.larger_far_touch_quant \
            else [1, 0, 0, 0]
        qa = const([[0, 0, 0, 0], row1, [0, 1, 0, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], torch.int32, action.device)
        quants = qa[action.long()] * self.cfg.fixed_quant_value
        return (self._cap_quants(quants, qa[1], state),
                self._task_prices(world, state))

    def _quants_fixed_quants_complex(self, action, world, state):
        """(quants, prices) ``(E, n, 4)`` (ref: vision_env.py:1537-1587)."""
        prices = self._task_prices(world, state)
        qa = const(_QUANT_ARRAY, torch.int32, action.device)
        quants = qa[action.long()] * self.cfg.fixed_quant_value  # (E, n, 4)
        return self._cap_quants(quants, qa[1], state), prices

    def _quants_fixed_quants_1msg(self, action, world, state):
        """One message at the level the action picks, 0 = no trade
        (ref: execution.py:177-186)."""
        prices4 = self._task_prices(world, state)
        level = torch.clamp(action.long() - 1, min=0)[..., None]
        price = torch.gather(prices4, -1, level)
        quant = torch.where(action == 0, 0, self.cfg.fixed_quant_value)
        quant = torch.minimum(quant, state.task_to_execute
                              - state.quant_executed)
        return quant[..., None].to(torch.int32), price

    def _twap_v3_quants(self, world: WorldState, state: ExecState,
                        swap: Tensor) -> Tensor:
        """twapV3 two-level split (ref: execution.py:230-246): the pair
        (ceil(q/steps) - half, half) over (FT, NT), swapped where ``swap``;
        two market-size orders in the last 60 seconds."""
        remaining_time = (self.wcfg.episode_time
                          - (world.time - world.init_time)[:, 0])
        if_market = (remaining_time <= 60)[:, None, None]
        quant_left = state.task_to_execute - state.quant_executed
        steps_left = torch.clamp(world.max_steps_in_episode
                                 - world.step_counter, min=1)[:, None]
        step_quant = torch.ceil(quant_left / steps_left).to(torch.int32)
        half = torch.div(step_quant, 2, rounding_mode="floor")
        first, second = step_quant - half, half
        limit = torch.stack([torch.where(swap, second, first),
                             torch.where(swap, first, second)], dim=-1)
        market = torch.stack([step_quant, step_quant], dim=-1)
        return torch.where(if_market, market, limit)

    @staticmethod
    def _fit_task(quants: Tensor, state: ExecState, ties: Tensor) -> Tensor:
        """Round, clip to the task's remainder and, where the sum still
        exceeds it, truncate by randomized Hamilton apportionment
        (ref: execution.py:260-265, :280-285)."""
        remain = (state.task_to_execute - state.quant_executed)[..., None]
        if quants.is_floating_point():
            quants = torch.round(quants)
        quants = torch.minimum(torch.clamp(quants, min=0), remain).to(
            torch.int32)
        fits = quants.sum(dim=-1, keepdim=True) <= remain
        ham = hamilton_apportionment_permuted(quants, remain[..., 0], ties)
        return torch.where(fits, quants, ham.to(torch.int32))

    def _quants_twap_v3(self, action, world, state, draw: ExecStepDraw):
        """twapV3 baseline (ref: execution.py:248-266); the policy action
        is ignored."""
        prices = self._task_prices(world, state)[..., self._ft_nt(action)]
        quants = self._twap_v3_quants(world, state, draw.swap)
        return self._fit_task(quants, state, draw.ties), prices

    def _reshape_action(self, action, world, state, draw: ExecStepDraw):
        """A ``fixed_prices`` action's quantities (ref: execution.py:
        268-285): with ``action_type='delta'`` the action adds to the
        twapV3 split; then they are fitted to the task."""
        if self.cfg.action_type == "delta":
            action = self._twap_v3_quants(world, state, draw.swap) + action
        return self._fit_task(action, state, draw.ties)

    def _quants_fixed_prices(self, action, world, state):
        """A quantity a price level (ref: execution.py:199-228) from the
        reshaped action: the ladder from the mean of the last 10 best
        quotes.  With 4 levels and mid equal to near touch, the mid order
        joins the near-touch one."""
        tick = self.wcfg.tick_size
        quants = action.to(torch.int32)
        best_ask = common.floor_tick(
            world.best_asks[:, -10:, 0].to(torch.float32).mean(dim=1), tick)
        best_bid = common.floor_tick(
            world.best_bids[:, -10:, 0].to(torch.float32).mean(dim=1), tick)
        full = self._ladder(best_ask.to(torch.int32)[:, None],
                            best_bid.to(torch.int32)[:, None], state)
        prices = full[..., const(_LADDER_ROWS[self.cfg.n_actions],
                                 torch.int64, full.device)]
        if self.cfg.n_actions == 4:
            combine = (prices[..., 1] == prices[..., 2])[..., None]
            moved = torch.stack([quants[..., 0], torch.zeros_like(
                quants[..., 1]), quants[..., 2] + quants[..., 1],
                quants[..., 3]], dim=-1)
            quants = torch.where(combine, moved, quants)
            no_mid = prices.clone()
            no_mid[..., 1] = -1
            prices = torch.where(combine, no_mid, prices)
        return quants, prices

    def _quants_twap(self, action, world, state):
        """TWAP baseline (ref: execution.py:287-301): the remainder over
        the steps left, at the far touch (action 0) or near touch."""
        steps_left = torch.clamp(world.max_steps_in_episode
                                 - world.step_counter - 1, min=1)[:, None]
        quant_left = state.task_to_execute - state.quant_executed
        step_quant = torch.ceil(quant_left / steps_left).to(torch.int32)
        prices = self._task_prices(world, state)[..., self._ft_nt(action)]
        qa = const([[1, 0], [0, 1]], torch.int32, action.device)
        return qa[action.long()] * step_quant[..., None], prices

    def _quants_simplest_case(self, action: Tensor, world: WorldState,
                         state: ExecState) -> Tuple[Tensor, Tensor]:
        """0 = no trade, 1 = far touch, 2 = near touch; (quants, prices)
        ``(E, n, 2)`` (ref: execution.py:188-197, vision_env.py:1145-1211).
        Over the remainder the far-touch row ``[fq, 0]`` scales it, so the
        order is ``fq`` times the remainder, as in the reference."""
        prices = self._task_prices(world, state)[..., self._ft_nt(action)]
        fq = self.cfg.fixed_quant_value
        qa = const([[0, 0], [fq, 0], [0, fq]], torch.int32, action.device)
        return self._cap_quants(qa[action.long()], qa[1], state), prices

    def _quants_policy_blending(self, action: Tensor, world: WorldState,
                                state: ExecState) -> Tuple[Tensor, Tensor]:
        """Continuous blend over the top-3 own-side levels, ``action``
        ``(E, n, 3)``; (quants, prices) ``(E, n, 4)`` with an all-zero 4th
        row (ref: execution.py:303-347, vision_env.py:1426-1534).

        Passive at the own-side top 3 levels; with ``blend_aggressive``
        level 1 is the far touch (it crosses the spread).  A missing level
        falls back one tick beyond the previous one."""
        tick = self.wcfg.tick_size
        l2 = bk.get_vision_l2_state(self.wcfg, 3, world.books)  # (E,3,2,2)
        ask = l2[:, None, :, 0, 0]                               # (E, 1, 3)
        bid = l2[:, None, :, 0, 1]
        aggressive = self.cfg.blend_aggressive

        def ladder(far, own, step):
            p1 = far[..., 0] if aggressive else own[..., 0]
            q2 = own[..., 0] if aggressive else own[..., 1]
            p2 = torch.where(q2 != -1, q2, p1 + step)
            q3 = own[..., 1] if aggressive else own[..., 2]
            p3 = torch.where(q3 != -1, q3, p2 + step)
            return torch.stack([p1, p2, p3], dim=-1)

        is_sell = (state.is_sell_task != 0)[..., None]
        prices3 = torch.where(is_sell, ladder(bid, ask, tick),
                              ladder(ask, bid, -tick)).to(torch.int32)
        v_twap = (state.task_to_execute
                  / world.max_steps_in_episode[:, None])[..., None]
        v_base = F.pad(v_twap, (0, 2))                   # [v_twap, 0, 0]
        target = torch.floor(torch.clamp(v_base + v_twap * action, min=0)
                             ).to(torch.int32)
        quant_left = (state.task_to_execute - state.quant_executed)[..., None]
        total = target.sum(dim=-1, keepdim=True, dtype=torch.int32)
        scale = torch.where(total > quant_left,
                            quant_left / (total + 1e-6), 1.0)
        target = torch.floor(target * scale).to(torch.int32)
        pad = torch.zeros_like(target[..., :1])
        return (torch.cat([target, pad], dim=-1),
                torch.cat([prices3, pad], dim=-1))

    def _need_draw(self, draw: Optional[ExecStepDraw]) -> None:
        space = self.cfg.action_space
        if draw is None and space in ("twap_v3", "fixed_prices"):
            raise ValueError(f"action_space={space!r} draws each step: "
                             "pass its ExecStepDraw")

    def get_action_msgs(self, action: Tensor, world: WorldState,
                        state: ExecState, params: ExecParams,
                        draw: Optional[ExecStepDraw] = None) -> Tensor:
        """The action's messages, ``(E, n, k, 8)`` (ref: execution.py:
        349-362).  ``twap_v3`` takes this step's :class:`ExecStepDraw`
        where the JAX function takes a key; a ``fixed_prices`` action is
        taken as :meth:`get_messages` reshapes it, as the JAX function
        takes it."""
        dev = action.device
        space = self.cfg.action_space
        if space == "twap_v3":
            self._need_draw(draw)
            quants, prices = self._quants_twap_v3(action, world, state, draw)
        else:
            quants, prices = getattr(self, f"_quants_{space}")(
                action, world, state)
        n = self.cfg.num_action_messages
        side = (1 - state.is_sell_task * 2)[..., None]
        return common.build_action_msgs(
            types=torch.ones(n, dtype=torch.int32, device=dev),
            sides=side * torch.ones(n, dtype=torch.int32, device=dev),
            quants=quants, prices=prices,
            order_ids=self.wcfg.placeholder_order_id,
            trader_ids=params.trader_id[None, :, None],
            time=world.time, time_delay=params.time_delay_obs_act)

    def get_messages(self, action: Tensor, world: WorldState,
                     state: ExecState, params: ExecParams,
                     draw: Optional[ExecStepDraw] = None
                     ) -> Tuple[Tensor, Tensor]:
        """Action and cancel messages, ``(E, n, k, 8)`` each
        (ref: execution.py:364-389); ``draw``: this step's draws of the
        spaces that draw (:meth:`draw_step`)."""
        self._need_draw(draw)
        if self.cfg.action_space == "fixed_prices":
            action = self._reshape_action(action, world, state, draw)
        action_msgs = self.get_action_msgs(action, world, state, params,
                                           draw)
        # cancels target the task's own side: asks for a sell task
        books = world.books
        tid = params.trader_id[None, :].expand(action.shape[0], -1)
        size = self.cfg.num_messages // 2
        is_sell = state.is_sell_task != 0
        cnl_asks = bk.make_cancel_msgs(books.asks, tid, size,
                                       1 - state.is_sell_task * 2,
                                       world.time[:, 0], world.time[:, 1])
        cnl_bids = bk.make_cancel_msgs(books.bids, tid, size,
                                       1 - state.is_sell_task * 2,
                                       world.time[:, 0], world.time[:, 1])
        cancel_msgs = torch.where(is_sell[..., None, None], cnl_asks,
                                  cnl_bids)
        return common.filter_messages(action_msgs, cancel_msgs)

    # ------------------------------------------------------------------

    def get_reward(self, world: WorldState, state: ExecState,
                   params: ExecParams, bestasks: Tensor, bestbids: Tensor,
                   summary: common.TradeSummary, time: Tensor
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Doom trade + the ``normal``, ``finish_fast``, ``simplest_case``
        or ``dual_ppo`` reward (ref: execution.py:395-527).  Returns the
        scaled reward (``finish_fast``: over 10, ``simplest_case``: over
        the task size) and the extras; ``time`` is the step's last message
        time."""
        cfg, wcfg = self.cfg, self.wcfg
        tick = wcfg.tick_size
        col = lambda v: v[:, None]                     # noqa: E731
        quant_this_step = summary.signed_sum.abs()
        quant_left0 = state.task_to_execute - (state.quant_executed
                                               + quant_this_step)
        if wcfg.ep_type == "fixed_time":
            remaining = wcfg.episode_time - (time - world.init_time)[:, 0]
            ep_is_over = col(remaining <= wcfg.last_step_seconds)
        else:
            ep_is_over = col(world.max_steps_in_episode - world.step_counter
                             - 1 <= 1)
        penalty = cfg.doom_price_penalty
        is_sell = state.is_sell_task != 0
        doom_price = torch.where(
            is_sell,
            common.floor_tick(col(bestbids[:, -1, 0]) * (1 - penalty), tick),
            common.floor_tick(col(bestasks[:, -1, 0]) * (1 + penalty), tick)
        ).to(torch.int32)
        side_sign = state.is_sell_task * 2 - 1
        tid = params.trader_id[None, :]
        s = common.summary_add_trade(
            summary, ep_is_over & (quant_left0.abs() > 0), tid, doom_price,
            (side_sign * quant_left0.abs()).to(torch.int32),
            pass_tid=wcfg.artificial_id_end_episode, agr_tid=tid, tick=tick)
        doom_quant = ep_is_over.to(torch.int32) * quant_left0

        agent_quant = s.agent_quant_abs
        direction = torch.sign(state.is_sell_task * 2 - 1)
        revenue = s.agent_pq_tick
        step = col(world.step_counter)

        def rm(avg, new):
            return common.rolling_mean(avg, new, step)

        trade_duration_step = ((s.dur_wsum - col(world.init_time[:, 0])
                                * agent_quant) / state.task_to_execute)
        trade_duration = state.trade_duration + trade_duration_step
        quant_left = state.task_to_execute - state.quant_executed - agent_quant
        init_tick = torch.div(state.init_price, tick, rounding_mode="floor")
        # money terms that nearly cancel: one rounding (common.mul_add)
        slippage_rm = rm(state.slippage_rm,
                         common.mul_sub(revenue, init_tick, agent_quant))

        if cfg.reward_space == "dual_ppo":
            # (ref: execution.py:452-470, vision_env.py:2160-2240)
            p_benchmark = torch.where(
                is_sell,
                col(torch.div(bestbids[:, -1, 0], tick, rounding_mode="floor")),
                col(torch.div(bestasks[:, -1, 0], tick, rounding_mode="floor")))
            v_base = state.task_to_execute / col(world.max_steps_in_episode)
            r_comp = direction * (revenue - agent_quant * p_benchmark)
            r_mimic = -(agent_quant - v_base).abs() / (v_base + 1.0)
            reward = r_comp + cfg.mimic_alpha * r_mimic
            drift = direction * agent_quant * (p_benchmark - init_tick)
            vwap_rm = rm(state.vwap_rm, p_benchmark)
            price_adv_rm = rm(state.price_adv_rm, r_comp)
            price_drift_rm = rm(state.price_drift_rm, p_benchmark - init_tick)
            advantage = r_comp
            reward_lam1 = r_comp
        else:
            other_q = s.other_quant
            vwap = torch.where(other_q == 0, state.init_price / tick,
                               s.other_pq_tick / torch.clamp(other_q, min=1))
            vwap_rm = rm(state.vwap_rm, vwap)
            price_adv_rm = rm(state.price_adv_rm,
                              revenue / (agent_quant + 0.001) - vwap)
            price_drift_rm = rm(state.price_drift_rm, vwap - init_tick)
            advantage = direction * common.mul_sub(revenue, vwap,
                                                   agent_quant)
            drift = direction * agent_quant * (vwap - init_tick)
            reward = common.mul_add(advantage, params.reward_lambda[None, :],
                                    drift)
            reward_lam1 = direction * common.mul_sub(revenue, init_tick,
                                                     agent_quant)
            if cfg.reward_space == "finish_fast":
                reward = -quant_left.abs() / 10
            elif cfg.reward_space == "simplest_case":
                # (ref: execution.py:496-510) sum((p - init_price) * |q|)
                # without int32 wrap: fill prices are on the tick grid, so
                # split init_price into ticks (exact integers) and the
                # sub-tick rest (exact in float32)
                sign = torch.where(is_sell, 1.0, -1.0)
                iq = torch.floor(state.init_price / tick).to(torch.int32)
                frac = state.init_price - iq.to(torch.float32) * tick
                diff_ticks = revenue - iq * agent_quant
                reward = sign * common.mul_sub(
                    diff_ticks.to(torch.float32) * tick, frac, agent_quant)
                reward = reward / cfg.task_size
        extras = {
            "reward": reward,
            "agentQuant": agent_quant,
            "revenue": revenue,
            "reward_lam1": reward_lam1,
            "slippage_rm": slippage_rm,
            "price_adv_rm": price_adv_rm,
            "price_drift_rm": price_drift_rm,
            "vwap_rm": vwap_rm,
            "advantage": advantage,
            "drift": drift,
            "doom_quant": doom_quant,
            "quant_left": quant_left,
            "trade_duration": trade_duration,
        }
        return reward, extras

    def is_terminal(self, world: WorldState, state: ExecState) -> Tensor:
        """(ref: vision_env.py:480-518)"""
        task_done = state.task_to_execute - state.quant_executed <= 0
        if self.wcfg.ep_type == "fixed_time":
            time_done = (self.wcfg.episode_time
                         - (world.time - world.init_time)[:, 0]
                         <= self.cfg.seconds_before_episode_end)
        else:
            time_done = world.max_steps_in_episode - world.step_counter <= 1
        return time_done[:, None] | task_done

    def update_state(self, world: WorldState, state: ExecState, extras
                     ) -> Tuple[ExecState, Tensor, Dict[str, Tensor]]:
        """(ref: vision_env.py:2281-2342)"""
        new_state = state.replace(
            quant_executed=state.quant_executed + extras["agentQuant"],
            total_revenue=state.total_revenue + extras["revenue"],
            drift_return=state.drift_return + extras["drift"],
            advantage_return=state.advantage_return + extras["advantage"],
            slippage_rm=extras["slippage_rm"],
            price_adv_rm=extras["price_adv_rm"],
            price_drift_rm=extras["price_drift_rm"],
            vwap_rm=extras["vwap_rm"],
            trade_duration=extras["trade_duration"])
        done = self.is_terminal(world, new_state)
        info = Info({
            "quant_left": extras["quant_left"],
            "done": done,
            "revenue_direction_normalised": extras["reward_lam1"],
            "drift": extras["drift"],
            "advantage": extras["advantage"],
            "doom_quant": extras["doom_quant"],
            "is_sell_task": new_state.is_sell_task,
            "reward": extras["reward"],
        })
        return new_state, done, info

    # ------------------------------------------------------------------

    def get_observation(self, world: WorldState, state: ExecState,
                        stream=None):
        """The flat observation ``(E, n, d)``, or with ``use_vision_obs``
        the dict ``{"obs": (E, n, d), "vision_obs": (E, n, levels, 3, 2)}``
        (ref: execution.py:741-760); ``stream`` is unused."""
        obs = {"execution_policy": self._obs_execution_policy,
               "simplest_case": self._obs_simplest,
               "basic": self._obs_basic,
               "engineered": self._obs_engineered}[
                   self.cfg.observation_space](world, state)
        if not self.cfg.use_vision_obs:
            return obs
        vision = self.get_vision_obs(world)
        return {"obs": obs, "vision_obs": vision[:, None].expand(
            (-1, obs.shape[1]) + vision.shape[1:])}

    def _obs_basic(self, world: WorldState, state: ExecState) -> Tensor:
        """Best ask, best bid and the quantity left, ``(E, n, 3)``
        (ref: execution.py:594-607)."""
        shape = state.quant_executed.shape
        w = lambda v: v[:, None].expand(shape)         # noqa: E731
        obs = {
            "best_ask_price": w(world.best_asks[:, -1, 0]),
            "best_bid_price": w(world.best_bids[:, -1, 0]),
            "remaining_quant": state.task_to_execute - state.quant_executed,
        }
        if self.cfg.normalize:
            means = {"best_ask_price": 1_550_000,
                     "best_bid_price": 1_550_000, "remaining_quant": 0}
            stds = {"best_ask_price": 1e3, "best_bid_price": 1e3,
                    "remaining_quant": self.cfg.task_size}
            obs = common.normalize_obs_dict(obs, means, stds)
        return common.flatten_obs_dict(obs)

    def _obs_engineered(self, world: WorldState, state: ExecState) -> Tensor:
        """Engineered features, ``(E, n, 12)`` float32, 15 in ``fixed_time``
        episodes (ref: execution.py:609-659)."""
        shape = state.quant_executed.shape
        w = lambda v: v[:, None].expand(shape)         # noqa: E731
        is_sell = state.is_sell_task != 0
        ask, bid = world.best_asks[:, -1], world.best_bids[:, -1]
        aggr_p = torch.where(is_sell, w(bid[:, 0]), w(ask[:, 0]))
        aggr_q = torch.where(is_sell, w(bid[:, 1]), w(ask[:, 1]))
        pass_p = torch.where(is_sell, w(ask[:, 0]), w(bid[:, 0]))
        pass_q = torch.where(is_sell, w(ask[:, 1]), w(bid[:, 1]))
        sign_switch = 2 * state.is_sell_task - 1
        max_steps = w(world.max_steps_in_episode)
        steps = w(world.step_counter)
        obs = {
            "is_sell_task": state.is_sell_task,
            "p_aggr": aggr_p * sign_switch,
            "p_pass": pass_p * sign_switch,
            "spread": (aggr_p - pass_p).abs(),
            "q_aggr": aggr_q,
            "q_pass": pass_q,
            "init_price": state.init_price,
            "current_task_size": state.task_to_execute,
            "executed_quant": state.quant_executed,
            "remaining_quant": state.task_to_execute - state.quant_executed,
            "step_counter": steps,
            "remaining_ratio": torch.where(
                max_steps == 0, torch.zeros((), device=steps.device),
                1.0 - steps / max_steps),
        }
        if self.wcfg.ep_type == "fixed_time":
            t = world.time[:, 0] + world.time[:, 1] / 1e9
            elapsed = t - (world.init_time[:, 0]
                           + world.init_time[:, 1] / 1e9)
            obs.update(time=w(t), delta_time=w(world.delta_time),
                       time_remaining=w(self.wcfg.episode_time - elapsed))
        if self.cfg.normalize:
            ts = self.cfg.task_size
            price_mean = state.init_price * sign_switch
            means = {"p_aggr": price_mean, "p_pass": price_mean}
            stds = {
                "is_sell_task": 1, "p_aggr": 1e5, "p_pass": 1e5,
                "spread": 1e4, "q_aggr": 100, "q_pass": 100,
                "init_price": 1e7, "current_task_size": ts,
                "executed_quant": ts, "remaining_quant": ts,
                "step_counter": 30, "remaining_ratio": 1,
                "time": 1e5, "delta_time": 10,
                "time_remaining": self.wcfg.episode_time,
            }
            obs = common.normalize_obs_dict(
                obs, {k: means.get(k, 0) for k in obs}, stds)
        return common.flatten_obs_dict(obs)

    def _obs_simplest(self, world: WorldState, state: ExecState) -> Tensor:
        """Time left, quantity left and mid price, ``(E, n, 3)`` float32
        (ref: execution.py:574-592, vision_env.py:2344-2379).  As in the
        reference, the time used is read in seconds against
        ``episode_time`` whatever the episode type."""
        shape = state.quant_executed.shape
        used = world.time - world.init_time
        left = (self.wcfg.episode_time - (used[:, 0] + used[:, 1] / 1e9)
                ) / self.wcfg.episode_time
        obs = {
            "percent_time_remaining": left[:, None].expand(shape),
            "percent_remaining_quant":
                (state.task_to_execute - state.quant_executed)
                / state.task_to_execute,
            "mid_price": world.mid_price[:, None].expand(shape),
        }
        if self.cfg.normalize:
            means = {"percent_time_remaining": 0.5,
                     "percent_remaining_quant": 0.5, "mid_price": 7_560_000}
            stds = {"percent_time_remaining": 1, "percent_remaining_quant": 1,
                    "mid_price": 1e3}
            obs = common.normalize_obs_dict(obs, means, stds)
        return common.flatten_obs_dict(obs)

    def normalize_vision_obs(self, raw: Tensor, world: WorldState
                             ) -> Tensor:
        """Raw ``(E, levels, 2, 2)`` book image -> ``(E, levels, 3, 2)``:
        (gap to mid in ticks, log1p volume, log1p cumulative volume) per
        (ask, bid) channel (ref: execution.py:661-678)."""
        tick = self.wcfg.tick_size
        mid = world.mid_price[:, None]

        def side_feats(prices, vols, gap_sign):
            valid = prices != -1
            gap = torch.where(valid, gap_sign * (prices - mid) / tick, 0.0)
            clean = torch.where(valid, vols, 0)
            cum = torch.where(valid, clean.cumsum(dim=1, dtype=torch.int32),
                              0)
            return torch.stack([gap, torch.log1p(clean), torch.log1p(cum)],
                               dim=2)

        return torch.stack([side_feats(raw[:, :, 0, 0], raw[:, :, 1, 0], 1.0),
                            side_feats(raw[:, :, 0, 1], raw[:, :, 1, 1], -1.0)],
                           dim=-1)

    def get_vision_obs(self, world: WorldState) -> Tensor:
        """Per-env book image ``(E, levels, 3, 2)`` (``(E, levels, 2, 2)``
        raw prices and volumes without ``normalize``)
        (ref: execution.py:680-686)."""
        raw = bk.get_vision_l2_state(self.wcfg, self.cfg.vision_levels,
                                     world.books)
        if self.cfg.normalize:
            return self.normalize_vision_obs(raw, world)
        return raw.to(torch.float32)

    def _obs_execution_policy(self, world: WorldState, state: ExecState
                              ) -> Tensor:
        """10 private + 9 aggressive-side + 9 passive-side features,
        ``(E, n, 28)`` (ref: execution.py:688-739)."""
        raw3 = bk.get_vision_l2_state(self.wcfg, 3, world.books)
        if self.cfg.normalize:
            feats = self.normalize_vision_obs(raw3, world)
        else:
            price = raw3[:, :, 0, :].to(torch.float32)
            vol = raw3[:, :, 1, :].to(torch.float32)
            cum = vol.clamp(min=0).cumsum(dim=1)
            feats = torch.stack([price, vol, cum], dim=2)
        # channel 0 = asks, 1 = bids; the aggressive side faces the task
        feats = feats[:, None]                            # (E, 1, 3, 3, 2)
        is_sell = (state.is_sell_task != 0)[..., None, None]
        aggr = torch.where(is_sell, feats[..., 1], feats[..., 0])
        pass_ = torch.where(is_sell, feats[..., 0], feats[..., 1])
        shape = state.quant_executed.shape
        w = lambda v: v[:, None].expand(shape)         # noqa: E731
        t = world.time[:, 0] + world.time[:, 1] / 1e9
        elapsed = t - (world.init_time[:, 0] + world.init_time[:, 1] / 1e9)
        steps, max_steps = w(world.step_counter), w(world.max_steps_in_episode)
        priv = {
            "is_sell_task": state.is_sell_task,
            "time": w(t),
            "delta_time": w(world.delta_time),
            "time_remaining": w(self.wcfg.episode_time - elapsed),
            "init_price": state.init_price,
            "current_task_size": state.task_to_execute,
            "executed_quant": state.quant_executed,
            "remaining_quant": state.task_to_execute - state.quant_executed,
            "step_counter": steps,
            "remaining_ratio": torch.where(
                max_steps == 0, torch.zeros((), device=steps.device),
                1.0 - steps / max_steps),
        }
        if self.cfg.normalize:
            ts = self.cfg.task_size
            stds = {
                "is_sell_task": 1, "time": 1e5, "delta_time": 10,
                "time_remaining": self.wcfg.episode_time, "init_price": 1e7,
                "current_task_size": ts, "executed_quant": ts,
                "remaining_quant": ts, "step_counter": 30,
                "remaining_ratio": 1,
            }
            priv = common.normalize_obs_dict(priv, dict.fromkeys(priv, 0),
                                             stds)
        order = ("is_sell_task", "init_price", "current_task_size",
                 "executed_quant", "remaining_quant", "step_counter",
                 "remaining_ratio", "time", "delta_time", "time_remaining")
        private = torch.stack([priv[k].to(torch.float32) for k in order],
                              dim=-1)
        return torch.cat([private, aggr.flatten(-2), pass_.flatten(-2)],
                         dim=-1)

    def action_space(self):
        """(ref: execution.py:766-776)"""
        if self.cfg.action_space == "fixed_prices":
            return spaces.Box(0, 100, (self.cfg.n_actions,), torch.int32)
        if self.cfg.action_space == "policy_blending":
            return spaces.Box(torch.tensor([-1.0, 0.0, 0.0]),
                              torch.tensor([3.0, 1.0, 1.0]), (3,))
        return spaces.Discrete(self.cfg.num_actions)

    def observation_space(self):
        """(ref: execution.py:778-792)"""
        engineered = 15 if self.wcfg.ep_type == "fixed_time" else 12
        dim = {"execution_policy": 28, "simplest_case": 3, "basic": 3,
               "engineered": engineered}[self.cfg.observation_space]
        flat = spaces.Box(-10_000, 10_000, (dim,))
        if self.cfg.use_vision_obs:
            vision = spaces.Box(-100, 1e8, (self.cfg.vision_levels, 3, 2))
            return spaces.Dict({"obs": flat, "vision_obs": vision})
        return flat
