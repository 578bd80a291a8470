"""Object-oriented facade over the engine.

Port of ``vit_marl_tpu/lob/orderbook.py`` (the reference's
``jorderbook.OrderBook``, ref: gymnax_exchange/jaxob/jorderbook.py:19-283).
Its state is a batch of books with a leading env axis, a single book being
E=1: ``(book, trades)`` as :mod:`vit_marl_tpu_torch.lob.engine` takes and
returns it.  The facade runs on its device, ``cuda`` unless the caller
asks for the CPU, and moves what it is given there.  Where the JAX facade
takes a PRNG key, this one takes the random-cancel ``uniforms=`` or a
``generator=`` (see the engine).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.lob import engine
from vit_marl_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor
State = Tuple[bk.BookState, Tensor]


class OrderBook:
    """Stateless wrapper: every state is a ``(book, trades)`` pair."""

    def __init__(self, cfg: Optional[EngineConfig] = None, device=None):
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)

    def _on(self, x) -> Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int32)

    def _uniforms(self, u) -> Optional[Tensor]:
        return None if u is None else torch.as_tensor(
            u, dtype=torch.float32, device=self.device)

    # -- state construction ----------------------------------------------

    def init(self, n_envs: int = 1) -> State:
        """Empty books and trade logs."""
        return (bk.init_book(self.cfg, n_envs, self.device),
                bk.init_trades(self.cfg, n_envs, self.device))

    def reset(self, l2_book, time=None) -> State:
        """Fresh books replayed from L2 snapshot rows, ``(4*levels,)`` or
        ``(E, 4*levels)``; ``time`` ``(2,)`` or ``(E, 2)``, default
        ``[34200, 0]`` (ref: jorderbook.py:42-55).  The replayed messages
        are limit orders, so the random-cancel stages never decide
        anything: zeros stand in for the uniforms."""
        l2 = self._on(l2_book)
        l2 = l2.reshape(-1, l2.shape[-1])
        E = l2.shape[0]
        t = self._on([34_200, 0] if time is None else time)
        msgs = bk.init_msgs_from_l2(self.cfg, l2, t.reshape(-1, 2).expand(
            E, 2))
        zeros = torch.zeros((msgs.shape[1], E), dtype=torch.float32,
                            device=self.device)
        return engine.process_messages(self.cfg, msgs, *self.init(E),
                                       uniforms=zeros)

    # -- message processing ----------------------------------------------

    def process_order_array(self, state: State, msg, uniforms=None,
                            generator=None) -> State:
        """One message a env, ``(E, 8)``."""
        return engine.process_message(self.cfg, *state, self._on(msg),
                                      self._uniforms(uniforms), generator)

    def process_orders_array(self, state: State, msgs, uniforms=None,
                             generator=None) -> State:
        """Messages ``(E, M, 8)`` in order."""
        return engine.process_messages(self.cfg, self._on(msgs), *state,
                                       self._uniforms(uniforms), generator)

    def process_orders_array_l2(self, state: State, msgs, n_levels: int,
                                uniforms=None, generator=None
                                ) -> Tuple[State, Tensor]:
        """Process messages and return the resulting L2 state."""
        state = self.process_orders_array(state, msgs, uniforms, generator)
        return state, self.get_l2_state(state, n_levels)

    # -- queries ----------------------------------------------------------

    def get_l2_state(self, state: State, n_levels: int = 10) -> Tensor:
        return bk.get_l2_state(self.cfg, n_levels, state[0])

    def get_vision_l2_state(self, state: State, n_levels: int = 10
                            ) -> Tensor:
        return bk.get_vision_l2_state(self.cfg, n_levels, state[0])

    def get_best_bid_and_ask(self, state: State) -> Tuple[Tensor, Tensor]:
        """``(best_bid, best_ask)``, each ``(E,)``, like the reference
        facade."""
        a, b = bk.best_bid_and_ask(self.cfg, state[0].asks, state[0].bids)
        return b, a

    def get_volume_at_price(self, state: State, side: int, price) -> Tensor:
        s = state[0].bids if side == 1 else state[0].asks
        return bk.volume_at_price(s, price)

    def get_agent_trades(self, state: State, agent_id) -> Tensor:
        return bk.get_agent_trades(state[1], agent_id)
