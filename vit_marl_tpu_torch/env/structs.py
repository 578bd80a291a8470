"""State, parameter and draw containers of the environment layer.

Port of ``vit_marl_tpu/env/structs.py``.  Every leaf carries the env batch
as its leading axis (the JAX package adds it with ``vmap``); per-agent
leaves are ``(E, n)`` for ``n`` instances of a type.  The book is one
``(E, 2, 6, S)`` tensor (:class:`vit_marl_tpu_torch.lob.book.BookState`
layout).  The world state carries the step's ``(E, n_trades, 8)`` trade
log only in ``debug_mode``: the main path folds every fill into
per-trader sums inside the book scan and never builds one.  A step's
info dicts are :class:`Info`: their fields stacked in one buffer a
(dtype, shape).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from vit_marl_tpu_torch.lob.book import BookState

Tensor = torch.Tensor


class _Replace:
    def replace(self, **kw):
        return replace(self, **kw)


@dataclass
class LoadedState(_Replace):
    """Replayed book state at a window start (ref: StatesandParams.py:58-68).
    In the reset table the leading axis is the window."""

    book: Tensor            # (E, 2, 6, S) int32
    init_time: Tensor       # (E, 2) [s, ns]
    window_index: Tensor    # (E,)
    max_steps_in_episode: Tensor
    start_index: Tensor     # index of the first data message of the window
    step_counter: Tensor

    @property
    def books(self) -> BookState:
        return BookState(self.book)


@dataclass
class WorldState(LoadedState):
    """Shared market state (ref: StatesandParams.py:71-80)."""

    best_bids: Tensor       # (E, num_msgs_per_step, 2) [price, quant]
    best_asks: Tensor
    time: Tensor            # (E, 2)
    order_id_counter: Tensor
    mid_price: Tensor       # float32
    delta_time: Tensor      # float32
    # (E, n_trades, 8) int32 trade log of the last step; debug_mode only
    trades: Optional[Tensor] = None


@dataclass
class MMState(_Replace):
    """Market-making agent state (ref: StatesandParams.py:92-97)."""

    inventory: Tensor       # (E, n) int32
    total_PnL: Tensor       # float32
    cash_balance: Tensor    # float32


@dataclass
class ExecState(_Replace):
    """Execution agent state (ref: StatesandParams.py:99-114)."""

    init_price: Tensor
    task_to_execute: Tensor
    quant_executed: Tensor
    total_revenue: Tensor
    drift_return: Tensor
    advantage_return: Tensor
    slippage_rm: Tensor
    price_adv_rm: Tensor
    price_drift_rm: Tensor
    vwap_rm: Tensor
    is_sell_task: Tensor
    trade_duration: Tensor


@dataclass
class MultiAgentState(_Replace):
    world: WorldState
    agents: Tuple[Any, ...]   # per-type agent states


@dataclass
class WorldParams:
    """Loaded data (ref: StatesandParams.py LoadedEnvParams)."""

    message_data: Tensor       # (N, 8) int32
    init_states: LoadedState   # stacked over windows


@dataclass
class MMParams:
    """Per-instance market-maker params, ``(n,)`` each."""

    trader_id: Tensor
    time_delay_obs_act: Tensor
    normalize: Tensor


@dataclass
class ExecParams:
    """Per-instance execution params, ``(n,)`` each."""

    trader_id: Tensor
    task_size: Tensor
    reward_lambda: Tensor
    time_delay_obs_act: Tensor
    normalize: Tensor


@dataclass
class MultiAgentParams:
    world: WorldParams
    agents: Tuple[Any, ...]


@dataclass
class Stream:
    """What the message observations read of a step (ref: world.py:
    163-167, :305-306): the combined stream, the mid price and the L2
    book before the step."""

    msgs: Tensor            # (E, M, 8) int32
    old_mid: Tensor         # (E,) float32
    lob_before: Tensor      # (E, 40) int32


class Info(Mapping):
    """One info dict of a step, its fields held in one buffer a (dtype,
    shape): the fields of a group are stacked in one launch, and a reader
    that wants them all (``rl/ppo.py::_reduce_info``) takes each buffer
    whole.  Reads as a dict of ``(E, ...)`` views, keys in the order
    given."""

    def __init__(self, fields: Mapping[str, Tensor]):
        groups: Dict[Any, list] = {}
        for k, v in fields.items():
            groups.setdefault((v.dtype, tuple(v.shape)), []).append(k)
        self.buffers = []            # [(names, (k, *shape) tensor)]
        self._where = {}
        for names in groups.values():
            vals = [fields[k] for k in names]
            buf = torch.stack(vals) if len(vals) > 1 else vals[0][None]
            for j, k in enumerate(names):
                self._where[k] = (len(self.buffers), j)
            self.buffers.append((tuple(names), buf))
        self._order = tuple(fields)

    def __getitem__(self, key: str) -> Tensor:
        b, j = self._where[key]
        return self.buffers[b][1][j]

    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)


# --------------------------------------------------------------------------
# Random draws.  Every draw on the step path enters through these, so a test
# can hand the port the JAX package's draws; in production the port makes
# them from its own torch.Generator (WorldEnv.draw_reset / draw_step).
# --------------------------------------------------------------------------


@dataclass
class ResetDraws:
    window: Tensor                   # (E,) window index (base.py:83-88)
    agents: Tuple[Optional[Tensor], ...]   # per type; (E,) draw or None


@dataclass
class ExecStepDraw:
    """An execution type's per-step draws (ref: execution.py:230-285).

    ``swap``: ``(E, n)`` bool, the ``twap_v3`` split's permutation of its
    two levels (``jax.random.permutation`` of a 2-vector); ``ties``:
    ``(E, n, k)`` float32 uniforms in ``[0, 1)``, one a pick of the
    Hamilton apportionment (``utils/ints.py``)."""

    swap: Optional[Tensor]
    ties: Optional[Tensor]


@dataclass
class StepDraws:
    shuffle: Optional[Tensor]        # (E, n_action_msgs) permutation
    uniforms: Optional[Tensor]       # (M, E) float32 cancel uniforms
    reset: ResetDraws                # draws of the auto-reset
    # per type: the agents' own draws (ExecStepDraw) or None
    agents: Tuple[Optional[Any], ...] = ()
