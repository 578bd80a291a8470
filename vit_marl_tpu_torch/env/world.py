"""The multi-agent world environment, batched over envs.

Port of ``vit_marl_tpu/env/world.py::WorldEnv``.  The JAX package writes
one env and adds the batch with ``vmap``; here every stage takes the
whole ``(E, ...)`` batch, and the training path is the batched
:meth:`WorldEnv.reset` and :meth:`WorldEnv.step_vec`.  One step:

  data msgs -> per-type action + cancel messages -> central order ids and
  shuffle -> [cancels, actions, data] -> book scan (ops/book_kernel.py)
  -> rewards -> world and agent state updates -> dones -> observations
  (done agents zeroed) -> auto-reset of the envs whose agents are all
  done.

The book scan runs in aggregate mode (best prices and per-trader trade
sums) unless ``debug_mode`` is on.  Then it runs in records mode, the
step's trade log is built from the records and carried in the world
state and ``info["world"]``, and the rewards read their trade sums from
the log, as the JAX package's ``debug_mode`` step does.

The per-env gymnax/JaxMARL API of the JAX package is here too, on one
env with the JAX package's shapes (no env axis, per-type leaves ``(n,
...)``): :meth:`WorldEnv.reset_env`, :meth:`WorldEnv.step_env` (no
auto-reset; the XLA-scan engine ``lob/engine.py`` with the uncapped trade
log, which rides in the world state as the JAX ``WorldState.trades``
does, and the rewards' sums read from it), :meth:`WorldEnv.step`
(``step_env``, then ``reset_env`` where every agent is done),
:meth:`WorldEnv.action_space` and :meth:`WorldEnv.observation_space`.
The JAX package's ``reset`` is its per-env one; the port's :meth:`reset`
keeps the batched signature its trainers call.

Randomness enters as :class:`StepDraws` / :class:`ResetDraws` (one env's
for the per-env API: a per-message uniform ``(M,)``); without them the env
draws from the caller's ``torch.Generator``.  The streams differ from the
JAX package's threefry draws by design.

``VIT_MARL_ABLATE`` (a comma list of ``data``, ``agents``, ``shuffle``,
``build``, ``obs``, ``reset``) skips those stages of the step, as the JAX
package's hook does (ref: world.py:76-87): a profiling mode whose results
are wrong, announced on stderr.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from vit_marl_tpu_torch.config import CancelMode, MsgCol, MultiAgentConfig
from vit_marl_tpu_torch.data.lobster import LoadedData
from vit_marl_tpu_torch.env import base as env_base
from vit_marl_tpu_torch.env.common import (
    ffill_best_prices,
    summarize_trades,
    summary_from_aggs,
)
from vit_marl_tpu_torch.env.execution import ExecutionAgent
from vit_marl_tpu_torch.env.mm import MarketMakingAgent
from vit_marl_tpu_torch.env.structs import (
    Info,
    MultiAgentParams,
    MultiAgentState,
    ResetDraws,
    StepDraws,
    Stream,
    WorldState,
)
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.lob import engine
from vit_marl_tpu_torch.ops.book_kernel import (
    REC_K,
    finalize_trade_log_from_records,
    process_step_aggs,
    process_step_records,
)
from vit_marl_tpu_torch.utils.device import resolve_device
from vit_marl_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor

AGENT_REGISTRY = {
    "market_making": MarketMakingAgent,
    "execution": ExecutionAgent,
}


def _one_env(tree):
    """A batch of one env: an env axis of 1 on every leaf."""
    return tree_map(lambda v: v[None], tree)


def _one_env_draws(draws: StepDraws) -> StepDraws:
    """One env's step draws as a batch of one (the uniforms' env axis is
    the last)."""
    return StepDraws(
        shuffle=None if draws.shuffle is None else draws.shuffle[None],
        uniforms=None if draws.uniforms is None else draws.uniforms[:, None],
        reset=_one_env(draws.reset), agents=_one_env(draws.agents))


def _env0(tree):
    """A batch of one env without its env axis; an :class:`Info` becomes
    a dict."""
    if isinstance(tree, Info):
        return {k: v[0] for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _env0(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_env0(v) for v in tree)
    return tree_map(lambda v: v[0], tree)


def _where_done(done: Tensor, reset_tree, step_tree):
    """Leaf by leaf the reset's values in the envs that are ``done``
    ``(E,)``, the step's elsewhere (ref: marl_env.py:737-766)."""
    def sel(x, y):
        return torch.where(done.reshape(done.shape + (1,) * (x.dim() - 1)),
                           x, y)
    return tree_map(sel, reset_tree, step_tree)


class WorldEnv:
    def __init__(self, ma_config: MultiAgentConfig,
                 data: Optional[LoadedData] = None, device=None):
        self.device = resolve_device(device)
        self.wcfg = ma_config.world
        self.agent_types = [AGENT_REGISTRY[a.agent_kind](a, self.wcfg)
                            for a in ma_config.agents]
        self.n_per_type = tuple(ma_config.n_agents_per_type)
        self.num_msgs_per_step = ma_config.num_msgs_per_step
        self.num_action_msgs_per_step = sum(
            a.num_action_messages * n
            for a, n in zip(ma_config.agents, self.n_per_type))
        self._ablate = set(filter(None, os.environ.get(
            "VIT_MARL_ABLATE", "").split(",")))
        if self._ablate:
            print(f"WARNING: VIT_MARL_ABLATE={sorted(self._ablate)} — "
                  "step stages are SKIPPED in the step. This is a "
                  "profiling mode; semantics are broken (zeroed messages/"
                  "observations). Unset the env var for real runs.",
                  file=sys.stderr)
        self._world_params = env_base.make_world_params(
            self.wcfg, self.device, data)
        self.n_windows = int(self._world_params.init_states.window_index
                             .shape[0])
        for a in self.agent_types:
            # message-stream observations carry the world's combined
            # stream (ref: world.py:92-96)
            a.total_msgs_per_step = self.num_msgs_per_step
        self.needs_stream = any(a.needs_stream for a in self.agent_types)
        self.action_spaces = [a.action_space() for a in self.agent_types]
        self.observation_spaces = [a.observation_space()
                                   for a in self.agent_types]

    @property
    def default_params(self) -> MultiAgentParams:
        """(ref: marl_env.py:139-172)"""
        agent_params = []
        next_tid = self.wcfg.trader_id_range_start
        for agent, n in zip(self.agent_types, self.n_per_type):
            p, next_tid = agent.default_params(next_tid, n, self.device)
            agent_params.append(p)
        return MultiAgentParams(world=self._world_params,
                                agents=tuple(agent_params))

    # ------------------------------------------------------------------
    # draws
    # ------------------------------------------------------------------

    def draw_reset(self, n_envs: int, generator: torch.Generator
                   ) -> ResetDraws:
        """Window picks and agent reset draws."""
        window = env_base.pick_window(self.wcfg, self.n_windows, n_envs,
                                      generator)
        return ResetDraws(window=window, agents=tuple(
            a.draw_reset(n_envs, generator) for a in self.agent_types))

    def draw_step(self, n_envs: int, generator: torch.Generator
                  ) -> StepDraws:
        """Action shuffle (ref: world.py:201-203), random-cancel uniforms
        (ref: book_kernel.py:448-461), the agents' own draws
        (ref: world.py:181-190) and the auto-reset's draws."""
        shuffle = None
        if self.wcfg.shuffle_action_messages:
            keys = torch.rand((n_envs, self.num_action_msgs_per_step),
                              generator=generator, device=generator.device)
            shuffle = keys.argsort(dim=1)
        uniforms = None
        if self.wcfg.cancel_mode >= CancelMode.CANCEL_UNIFORM:
            uniforms = torch.rand((self.num_msgs_per_step, n_envs),
                                  generator=generator,
                                  device=generator.device)
        agents = tuple(a.draw_step(n_envs, n, generator)
                       for a, n in zip(self.agent_types, self.n_per_type))
        return StepDraws(shuffle=shuffle, uniforms=uniforms,
                         reset=self.draw_reset(n_envs, generator),
                         agents=agents)

    # ------------------------------------------------------------------
    # reset
    # ------------------------------------------------------------------

    def reset(self, draws: ResetDraws, params: MultiAgentParams
              ) -> Tuple[List[Tensor], MultiAgentState]:
        """Reset a batch of envs (ref: marl_env.py:168-237)."""
        load = env_base.gather_reset_state(params.world, draws.window)
        books = bk.BookState(load.book)
        best_ask, best_bid = bk.best_bid_and_ask_incl_quants(self.wcfg, books)
        M = self.num_msgs_per_step
        E = load.step_counter.shape[0]
        world = WorldState(
            book=load.book, init_time=load.init_time,
            window_index=load.window_index,
            max_steps_in_episode=load.max_steps_in_episode,
            start_index=load.start_index, step_counter=load.step_counter,
            best_bids=best_bid[:, None, :].expand(E, M, 2).clone(),
            best_asks=best_ask[:, None, :].expand(E, M, 2).clone(),
            time=load.init_time,
            order_id_counter=torch.full(
                (E,), self.wcfg.order_id_counter_start, dtype=torch.int32,
                device=load.book.device),
            mid_price=(best_bid[:, 0] + best_ask[:, 0]) / 2,
            delta_time=torch.zeros(E, device=load.book.device),
            trades=(bk.init_trades(self.wcfg, E, load.book.device)
                    if self.wcfg.debug_mode else None))
        obs_list, state_list = [], []
        for agent, ap, d in zip(self.agent_types, params.agents,
                                draws.agents):
            obs, st = agent.reset(ap, d, world)
            obs_list.append(obs)
            state_list.append(st)
        return obs_list, MultiAgentState(world=world,
                                         agents=tuple(state_list))

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def _actions(self, actions: Sequence[Tensor]) -> List[Tensor]:
        """Add the agent axis to the actions of single-instance types:
        ``(E,)`` -> ``(E, 1)``, ``(E, d)`` -> ``(E, 1, d)`` (ref:
        world.py:179-180 always adds it, whatever the action's rank)."""
        return [a[:, None] if n == 1 else a
                for a, n in zip(actions, self.n_per_type)]

    def _zero_obs(self, i: int, E: int):
        """Ablation stand-in observation (profiling only, ref:
        world.py:209-216)."""
        space, n = self.observation_spaces[i], self.n_per_type[i]
        if hasattr(space, "spaces"):
            return {k: torch.zeros((E, n) + tuple(s.shape),
                                   device=self.device)
                    for k, s in space.spaces.items()}
        return torch.zeros((E, n) + tuple(space.shape), device=self.device)

    def _build_messages(self, state: MultiAgentState, actions: List[Tensor],
                        params: MultiAgentParams,
                        shuffle: Optional[Tensor],
                        agent_draws: Sequence = ()
                        ) -> Tuple[Tensor, Tensor]:
        """Stages A-C: data slice, per-type action/cancel messages, central
        order ids and shuffle (ref: marl_env.py:241-344).  Returns the
        ``(E, M, 8)`` combined stream and the new order-id counters."""
        world = state.world
        E = world.step_counter.shape[0]
        if "data" in self._ablate:
            data_msgs = torch.zeros((E, self.wcfg.n_data_msg_per_step, 8),
                                    dtype=torch.int32, device=self.device)
        else:
            end_time = (world.init_time[:, 0] + self.wcfg.episode_time
                        if self.wcfg.ep_type == "fixed_time" else None)
            data_msgs = env_base.get_data_messages(
                self.wcfg, params.world.message_data, world.start_index,
                world.step_counter, end_time)
        all_action, all_cancel = [], []
        for i, agent in enumerate(self.agent_types):
            if "agents" in self._ablate:
                msgs_a = torch.zeros(
                    (E, self.n_per_type[i], agent.cfg.num_messages // 2, 8),
                    dtype=torch.int32, device=self.device)
                msgs_c = torch.zeros_like(msgs_a)
            else:
                msgs_a, msgs_c = agent.get_messages(
                    actions[i], world, state.agents[i], params.agents[i],
                    agent_draws[i] if agent_draws else None)
            all_action.append(msgs_a.reshape(E, -1, 8))
            all_cancel.append(msgs_c.reshape(E, -1, 8))
        action_msgs = torch.cat(all_action, dim=1)
        cancel_msgs = torch.cat(all_cancel, dim=1)
        n_act = self.num_action_msgs_per_step
        new_ids = (world.order_id_counter[:, None]
                   - torch.arange(n_act, device=data_msgs.device))
        action_msgs[:, :, MsgCol.OID] = new_ids.to(torch.int32)
        new_id_counter = world.order_id_counter - n_act
        if shuffle is not None and "shuffle" not in self._ablate:
            action_msgs = torch.gather(
                action_msgs, 1, shuffle.long()[:, :, None].expand(-1, -1, 8))
        combined = torch.cat([cancel_msgs, action_msgs, data_msgs], dim=1)
        return combined, new_id_counter

    def _post_engine(self, state: MultiAgentState, params: MultiAgentParams,
                     book: bk.BookState, bestasks: Tensor, bestbids: Tensor,
                     combined: Tensor, new_id_counter: Tensor, summaries,
                     trades: Optional[Tensor] = None,
                     lob_before: Optional[Tensor] = None):
        """Stages E-K: rewards, state updates, dones, infos, observations
        (ref: marl_env.py:420-662).  ``trades``: the step's trade log, in
        ``debug_mode`` only; ``lob_before``: the L2 book before the step,
        for message observations."""
        world = state.world
        final_time = combined[:, -1, -2:]
        rewards, extras_list = [], []
        for i, agent in enumerate(self.agent_types):
            r, ex = agent.get_reward(world, state.agents[i], params.agents[i],
                                     bestasks, bestbids, summaries[i],
                                     final_time)
            rewards.append(r)
            extras_list.append(ex)

        new_world = world.replace(
            book=book.data, best_asks=bestasks, best_bids=bestbids,
            time=final_time, order_id_counter=new_id_counter,
            step_counter=world.step_counter + 1,
            mid_price=(bestbids[:, -1, 0] + bestasks[:, -1, 0]) / 2,
            delta_time=(final_time[:, 0] + final_time[:, 1] / 1e9
                        - world.time[:, 0] - world.time[:, 1] / 1e9),
            trades=trades)

        new_agent_states, dones_list, infos_list = [], [], []
        for i, agent in enumerate(self.agent_types):
            st, dn, inf = agent.update_state(new_world, state.agents[i],
                                             extras_list[i])
            new_agent_states.append(st)
            dones_list.append(dn)
            infos_list.append(inf)
        new_state = MultiAgentState(world=new_world,
                                    agents=tuple(new_agent_states))
        done_all = torch.cat(dones_list, dim=1).all(dim=1)
        dones = {"__all__": done_all, "agents": dones_list}
        world_info = {
            "window_index": new_world.window_index,
            "end_mid_price": new_world.mid_price,
            "step_counter": new_world.step_counter,
            "time": new_world.time,
            "order_id_counter": new_world.order_id_counter,
            "average_best_ask": bestasks[:, :, 0].float().mean(dim=1),
            "average_best_bid": bestbids[:, :, 0].float().mean(dim=1),
            "delta_time": new_world.delta_time,
            "current_step": new_world.step_counter,
        }
        if self.wcfg.debug_mode:
            world_info.update(
                trades=trades, total_msgs=combined,
                lob_state=bk.get_l2_state(self.wcfg, 10, new_world.books))
        info = {"world": Info(world_info), "agents": infos_list}

        stream = (Stream(msgs=combined, old_mid=world.mid_price,
                         lob_before=lob_before)
                  if self.needs_stream else None)
        obs_list = []
        for i, agent in enumerate(self.agent_types):
            if "obs" in self._ablate:
                obs_list.append(self._zero_obs(i, combined.shape[0]))
                continue
            obs = agent.get_observation(new_world, new_agent_states[i],
                                        stream)
            mask = dones_list[i] & ~done_all[:, None]

            def zero_done(o, mask=mask):
                m = mask.reshape(mask.shape + (1,) * (o.dim() - mask.dim()))
                return torch.where(m, 0, o)     # keeps o's dtype

            obs_list.append(tree_map(zero_done, obs))
        return obs_list, new_state, rewards, dones, info

    @property
    def rec_k(self) -> int:
        """Fills recorded per message in ``debug_mode``: ``REC_K`` in the
        deterministic cancel modes, as the JAX package's records kernel
        keeps; every fill (``n_orders``) in the random-cancel modes, where
        the JAX package builds its debug log with the uncapped XLA scan
        (ref: world.py:340-356)."""
        if self.wcfg.cancel_mode >= CancelMode.CANCEL_UNIFORM:
            return self.wcfg.n_orders
        return min(REC_K, self.wcfg.n_orders)

    def _log_summaries(self, trades: Tensor, params: MultiAgentParams):
        """Each agent instance's trade sums read from the ``(E, n_trades,
        8)`` log, per type (ref: mm.py:304-306, execution.py:411-413)."""
        E = trades.shape[0]
        return [summarize_trades(trades[:, None].expand(E, n, -1, -1),
                                 p.trader_id[None, :].expand(E, n),
                                 self.wcfg.tick_size)
                for p, n in zip(params.agents, self.n_per_type)]

    def _debug_scan(self, combined: Tensor, books: bk.BookState,
                    prev: Tensor, params: MultiAgentParams,
                    uniforms: Optional[Tensor]):
        """The ``debug_mode`` engine stage (ref: world.py:426-434): the
        records scan, the step's trade log, and each agent instance's
        trade sums read from the log.  Returns (book, (bestasks,
        bestbids), per-type summaries, trades)."""
        E = combined.shape[0]
        book, best, (records, counts) = process_step_records(
            self.wcfg, combined, books, prev, self.rec_k, uniforms)
        trades = finalize_trade_log_from_records(
            bk.init_trades(self.wcfg, E, combined.device), records,
            combined, counts)
        return book, best, self._log_summaries(trades, params), trades

    def step_vec(self, state: MultiAgentState, actions: Sequence[Tensor],
                 params: MultiAgentParams,
                 draws: Optional[StepDraws] = None,
                 generator: Optional[torch.Generator] = None):
        """Batched auto-resetting step.

        ``actions``: one tensor per agent type, ``(E,)`` (discrete) or
        ``(E, d)`` (continuous) for a type with a single instance, else
        ``(E, n)`` or ``(E, n, d)``.  ``draws`` supplies every random
        draw of the step; when omitted they come from ``generator``.

        Returns ``(obs, state, rewards, dones, info)``: per-type ``(E, n,
        d)`` observations (or dicts of ``(E, n, ...)`` tensors) and
        ``(E, n)`` rewards, ``dones["agents"]`` per
        type ``(E, n)`` and ``dones["__all__"]`` ``(E,)``.
        """
        E = state.world.step_counter.shape[0]
        if draws is None:
            draws = self.draw_step(E, generator)
        actions = self._actions(actions)
        lob_before = (bk.get_l2_state(self.wcfg, 10, state.world.books)
                      if self.needs_stream else None)
        if "build" in self._ablate:
            combined = torch.zeros((E, self.num_msgs_per_step, 8),
                                   dtype=torch.int32, device=self.device)
            new_id_counter = state.world.order_id_counter
        else:
            combined, new_id_counter = self._build_messages(
                state, actions, params, draws.shuffle, draws.agents)

        prev = torch.stack([state.world.best_asks[:, -1, 0],
                            state.world.best_bids[:, -1, 0]], dim=1)
        if self.wcfg.debug_mode:
            book, (bestasks, bestbids), summaries, trades = self._debug_scan(
                combined, state.world.books, prev, params, draws.uniforms)
        else:
            trades = None
            tids = torch.cat([p.trader_id for p in params.agents])
            book, (bestasks, bestbids), (per_agent, totals) = \
                process_step_aggs(self.wcfg, combined, state.world.books,
                                  tids, prev, self.wcfg.tick_size,
                                  draws.uniforms)
            summaries, off = [], 0
            for n in self.n_per_type:
                summaries.append(summary_from_aggs(
                    per_agent[:, off:off + n],
                    totals[:, None, :].expand(E, n, totals.shape[-1])))
                off += n

        obs_st, st_st, rewards, dones, infos = self._post_engine(
            state, params, book, bestasks, bestbids, combined,
            new_id_counter, summaries, trades, lob_before)
        if "reset" in self._ablate:
            return obs_st, st_st, rewards, dones, infos

        # vectorised auto-reset (ref: marl_env.py:737-766)
        obs_re, st_re = self.reset(draws.reset, params)
        done = dones["__all__"]
        return (_where_done(done, obs_re, obs_st),
                _where_done(done, st_re, st_st), rewards, dones, infos)

    # ------------------------------------------------------------------
    # the per-env gymnax API (ref: world.py:115-152, :317-332, :484-507)
    # ------------------------------------------------------------------

    def _reset_logged(self, draws: ResetDraws, params: MultiAgentParams):
        """:meth:`reset` with an empty trade log in every world state."""
        obs, state = self.reset(draws, params)
        trades = bk.init_trades(self.wcfg, draws.window.shape[0],
                                state.world.book.device)
        return obs, state.replace(world=state.world.replace(trades=trades))

    def reset_env(self, draws: Optional[ResetDraws],
                  params: MultiAgentParams,
                  generator: Optional[torch.Generator] = None):
        """Reset one env (ref: world.py:115-152).  ``draws``: the env's
        :class:`ResetDraws` (a window index ``()``, per type a draw ``()``
        or None), else drawn from ``generator``.  Returns ``(obs,
        state)``: per type ``(n, d)`` observations, the state's leaves
        without an env axis, its world state holding an empty ``(n_trades,
        8)`` trade log (the JAX one holds the window replay's, empty but
        where a snapshot crosses)."""
        draws = (self.draw_reset(1, generator) if draws is None
                 else _one_env(draws))
        return _env0(self._reset_logged(draws, params))

    def _step_engine(self, state: MultiAgentState, actions: List[Tensor],
                     params: MultiAgentParams, draws: StepDraws):
        """:meth:`step_env` on a batch: the messages, the XLA-scan engine
        with the uncapped trade log and the best quotes forward-filled,
        the rewards' sums read from the log (ref: world.py:317-332)."""
        world = state.world
        E = world.step_counter.shape[0]
        actions = self._actions(actions)
        lob_before = (bk.get_l2_state(self.wcfg, 10, world.books)
                      if self.needs_stream else None)
        combined, new_id_counter = self._build_messages(
            state, actions, params, draws.shuffle, draws.agents)
        book, trades, (asks, bids) = engine.process_messages_save_bidask(
            self.wcfg, combined, world.books,
            bk.init_trades(self.wcfg, E, combined.device),
            self.num_msgs_per_step, uniforms=draws.uniforms)
        bestasks = ffill_best_prices(asks, world.best_asks[:, -1, 0])
        bestbids = ffill_best_prices(bids, world.best_bids[:, -1, 0])
        return self._post_engine(state, params, book, bestasks, bestbids,
                                 combined, new_id_counter,
                                 self._log_summaries(trades, params),
                                 trades, lob_before)

    def _env_inputs(self, state, actions, draws, generator):
        draws = (self.draw_step(1, generator) if draws is None
                 else _one_env_draws(draws))
        acts = [torch.as_tensor(a, device=self.device)[None]
                for a in actions]
        return _one_env(state), acts, draws

    def step_env(self, state: MultiAgentState, actions: Sequence,
                 params: MultiAgentParams,
                 draws: Optional[StepDraws] = None,
                 generator: Optional[torch.Generator] = None):
        """Step one env, without auto-reset (ref: world.py:317-332).

        ``state`` as :meth:`reset_env` returns it; ``actions`` one per
        type, unbatched for a single instance (``()`` or ``(d,)``), else
        ``(n, ...)``; ``draws`` the env's :class:`StepDraws` (uniforms
        ``(M,)``, shuffle ``(n_action_msgs,)``), else drawn from
        ``generator``.  The book runs through ``lob/engine.py``, not the
        book-scan kernel, and the step's uncapped ``(n_trades, 8)`` log is
        the new world state's ``trades``.  Returns ``(obs, state, rewards,
        dones, info)`` with the JAX package's structure, dicts for infos.
        """
        st, acts, draws = self._env_inputs(state, actions, draws, generator)
        return _env0(self._step_engine(st, acts, params, draws))

    def step(self, state: MultiAgentState, actions: Sequence,
             params: MultiAgentParams, draws: Optional[StepDraws] = None,
             generator: Optional[torch.Generator] = None):
        """:meth:`step_env`, then :meth:`reset_env` from ``draws.reset``
        where ``dones["__all__"]`` (ref: world.py:488-501)."""
        st, acts, draws = self._env_inputs(state, actions, draws, generator)
        obs_st, st_st, rewards, dones, info = self._step_engine(
            st, acts, params, draws)
        obs_re, st_re = self._reset_logged(draws.reset, params)
        done = dones["__all__"]
        return _env0((_where_done(done, obs_re, obs_st),
                      _where_done(done, st_re, st_st), rewards, dones, info))

    def action_space(self):
        """The action spaces, one a type (ref: world.py:503-504)."""
        return self.action_spaces

    def observation_space(self):
        """The observation spaces, one a type (ref: world.py:506-507)."""
        return self.observation_spaces


def make_world_env(ma_config: Optional[MultiAgentConfig] = None,
                   data: Optional[LoadedData] = None,
                   device=None) -> WorldEnv:
    """Convenience constructor with the default 2-player MM+Exec setup
    (ref: ``vit_marl_tpu/env/world.py::make_world_env``), on ``device``
    (the card unless ``device="cpu"``)."""
    return WorldEnv(ma_config or MultiAgentConfig(), data=data, device=device)
