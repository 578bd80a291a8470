"""Baseline policies with the trainer's network call.

Port of ``vit_marl_tpu/eval/baselines.py``: every policy is called as the
trainer calls its networks, ``policy(hidden, obs, dones) -> (hidden, pi,
value)`` with ``(1, actors, ...)`` observations, so learned and baseline
agents are interchangeable in rollouts.  The canonical baselines are the
``AvSt`` action space for the market maker and ``twap`` for the execution
agent, driven by these fixed or random action pickers.

Every call can be captured in a CUDA graph (``eval/combinations.py``):
no host read, no branch on a tensor's value, the same shapes each step,
and no copy from the host (a fixed continuous action is moved to a
device once, at its first call there, which is the eager warm-up).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vit_marl_tpu_torch.models.distributions import Categorical


class _DeterministicBox:
    """Degenerate continuous distribution returning a fixed action."""

    def __init__(self, value: torch.Tensor):
        self.value = value

    def sample(self, generator: Optional[torch.Generator] = None):
        return self.value

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.zeros(value.shape[:-1], device=value.device)

    def entropy(self) -> torch.Tensor:
        return torch.zeros(self.value.shape[:-1], device=self.value.device)

    def mode(self) -> torch.Tensor:
        return self.value


def _batch(obs):
    """(time, actors) of an observation or a dict of them, and its device."""
    leaf = next(iter(obs.values())) if isinstance(obs, dict) else obs
    return tuple(leaf.shape[:2]), leaf.device


class FixedActionPolicy:
    """Always the same action (ref: baseline_JAXMARL.py:141-159): a
    Discrete id with ``n_actions``, or a continuous vector."""

    def __init__(self, action, n_actions: Optional[int] = None,
                 continuous: bool = False):
        self.action = action
        self.n_actions = n_actions
        self.continuous = continuous
        self._on = {}           # device -> the continuous action there

    def __call__(self, hidden, obs, dones):
        batch, dev = _batch(obs)
        if self.continuous:
            a = self._on.get(dev)
            if a is None:
                a = self._on[dev] = torch.as_tensor(
                    np.array(self.action, np.float32), device=dev)
            pi = _DeterministicBox(a.expand(batch + tuple(a.shape)))
        else:
            logits = torch.full(batch + (self.n_actions,), -1e9, device=dev)
            logits[..., self.action] = 0.0
            pi = Categorical(logits)
        return hidden, pi, torch.zeros(batch, device=dev)


class RandomPolicy:
    """Uniform random discrete actions (ref: baseline_JAXMARL.py:127-139)."""

    def __init__(self, n_actions: int):
        self.n_actions = n_actions

    def __call__(self, hidden, obs, dones):
        batch, dev = _batch(obs)
        logits = torch.zeros(batch + (self.n_actions,), device=dev)
        return hidden, Categorical(logits), torch.zeros(batch, device=dev)


class LearnedPolicy:
    """A trained network in the shared call."""

    def __init__(self, network: nn.Module):
        self.network = network

    def __call__(self, hidden, obs, dones):
        return self.network(hidden, obs, dones)
