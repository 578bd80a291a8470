"""Recurrent actor-critic (port of ``vit_marl_tpu/models/rnn.py``).

``ScannedGRU`` is a reset-aware GRU run over the time axis; the cell has
flax ``GRUCell``'s exact form, which differs from ``torch.nn.GRUCell``: the
hidden-side projections of the reset and update gates carry no bias
(only the candidate's does)::

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

``ActorCriticRNN`` is Dense -> relu -> GRU -> {actor head, critic head}
with the reference's orthogonal gains (ref: ippo_rnn_JAXMARL.py:76-115);
the actor head is a ``Categorical`` over a ``Discrete`` space, or, given
a ``Box``'s bounds, a ``SquashedNormal`` with a learned ``log_std``
(ref: vit_marl_tpu/models/rnn.py:53-91).  :class:`ActorCritic` holds
the GRU and heads that the vision actor-critics share.  Weights are drawn from
torch's generator; ``models/bridge.py`` loads a flax parameter tree
instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from vit_marl_tpu_torch.models.distributions import Categorical, SquashedNormal


def _lecun_normal_(w: torch.Tensor) -> None:
    """flax's default Dense kernel init: truncated normal (2 std), variance
    1/fan_in (fan_in = in_features)."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class GRUCell(nn.Module):
    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Linear(in_features, 3 * hidden)     # ir, iz, in
        self.w_h = nn.Linear(hidden, 3 * hidden, bias=False)  # hr, hz, hn
        self.b_hn = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            for k in range(3):
                _lecun_normal_(self.w_i.weight[k * hidden:(k + 1) * hidden])
                nn.init.orthogonal_(self.w_h.weight[k * hidden:(k + 1) * hidden])
            self.w_i.bias.zero_()

    def forward(self, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step from precomputed input projections ``gi = w_i(x)``."""
        H = self.hidden
        gh = self.w_h(h)
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * (gh[..., 2 * H:] + self.b_hn))
        return (1.0 - z) * n + z * h


class ScannedGRU(nn.Module):
    """GRU over ``(T, B, F)`` inputs; the carry is zeroed where ``resets``
    is set, before the step (ref: ippo_rnn_JAXMARL.py:48-73)."""

    def __init__(self, features: int):
        super().__init__()
        self.cell = GRUCell(features, features)

    def forward(self, carry: torch.Tensor, ins: torch.Tensor,
                resets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gi = self.cell.w_i(ins)              # all steps at once
        ys = []
        for t in range(ins.shape[0]):
            carry = torch.where(resets[t][:, None], 0.0, carry)
            carry = self.cell(gi[t], carry)
            ys.append(carry)
        return carry, torch.stack(ys)

    @staticmethod
    def initialize_carry(batch_size: int, hidden_size: int,
                         device=None) -> torch.Tensor:
        return torch.zeros((batch_size, hidden_size), device=device)


def _dense(i: int, o: int, gain: float) -> nn.Linear:
    layer = nn.Linear(i, o)
    nn.init.orthogonal_(layer.weight, gain)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """Base of the actor-critics: the actor and critic heads on the GRU's
    output, Dense -> relu -> Dense for each with orthogonal gains 2 and
    0.01 (actor), 2 and 1 (critic).  ``action_low`` / ``action_high`` (a
    ``Box``'s bounds) make the actor a ``SquashedNormal`` with a learned
    ``log_std`` (zeros), else it is a ``Categorical``."""

    def _init_heads(self, fc_dim: int, hidden_size: int, action_dim: int,
                    action_low: Optional[torch.Tensor],
                    action_high: Optional[torch.Tensor]) -> None:
        if hidden_size != fc_dim:
            # the reference's GRU runs at the embedding width and its
            # carry at hidden_size; they must agree
            raise ValueError(f"hidden_size ({hidden_size}) must equal "
                             f"fc_dim ({fc_dim})")
        self.gru = ScannedGRU(fc_dim)
        self.actor_fc = _dense(fc_dim, hidden_size, 2.0)
        self.actor_out = _dense(hidden_size, action_dim, 0.01)
        self.critic_fc = _dense(fc_dim, fc_dim, 2.0)
        self.critic_out = _dense(fc_dim, 1, 1.0)
        self.continuous = action_low is not None
        if self.continuous:
            self.log_std = nn.Parameter(torch.zeros(action_dim))
            self.register_buffer("action_low", torch.as_tensor(
                action_low, dtype=torch.float32), persistent=False)
            self.register_buffer("action_high", torch.as_tensor(
                action_high, dtype=torch.float32), persistent=False)

    def _recurrent_heads(self, hidden: torch.Tensor, emb: torch.Tensor,
                         dones: torch.Tensor):
        """The GRU over ``emb``, then the heads: (hidden, pi, value)."""
        hidden, emb = self.gru(hidden, emb, dones)
        actor_out = self.actor_out(torch.relu(self.actor_fc(emb)))
        if self.continuous:
            pi = SquashedNormal(actor_out, self.log_std, self.action_low,
                                self.action_high)
        else:
            pi = Categorical(actor_out)
        value = self.critic_out(torch.relu(self.critic_fc(emb)))
        return hidden, pi, value.squeeze(-1)


class ActorCriticRNN(ActorCritic):
    """(time, batch, obs) + (time, batch) dones -> (hidden, pi, value)."""

    def __init__(self, obs_dim: int, action_dim: int, fc_dim: int = 64,
                 hidden_size: int = 64,
                 action_low: Optional[torch.Tensor] = None,
                 action_high: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _dense(obs_dim, fc_dim, math.sqrt(2))
        self._init_heads(fc_dim, hidden_size, action_dim, action_low,
                         action_high)

    def forward(self, hidden: torch.Tensor, obs: torch.Tensor,
                dones: torch.Tensor):
        emb = torch.relu(self.embed(obs))
        return self._recurrent_heads(hidden, emb, dones)
