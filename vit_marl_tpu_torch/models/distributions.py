"""Action distributions (port of ``vit_marl_tpu/models/distributions.py``).

``Categorical`` for discrete heads; ``SquashedNormal`` for the continuous
``Box`` action of ``policy_blending``.  Samples come from a
``torch.Generator`` (the JAX package draws from threefry keys; the streams
differ), or from standard-normal draws the caller passes in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    def sample(self, generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Gumbel-max sample from ``generator`` (the JAX package draws
        ``jax.random.categorical``; the streams differ), or from
        ``uniforms`` in ``[0, 1)`` of the logits' shape."""
        u = uniforms
        if u is None:
            u = torch.rand(self.logits.shape, generator=generator,
                           device=self.logits.device)
        u = u.clamp(min=torch.finfo(u.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, value.long()[..., None]
                            ).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        p = torch.exp(self.logits)
        return -(p * self.logits).sum(dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


class SquashedNormal:
    """Diagonal Gaussian squashed by tanh and mapped affinely into
    ``[low, high]``, with change-of-variables log-probs."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor,
                 low: torch.Tensor, high: torch.Tensor):
        self.mean = mean
        self.log_std = log_std
        self.low = low
        self.high = high
        self._scale = (high - low) / 2.0
        self._mid = (high + low) / 2.0

    def _squash(self, u: torch.Tensor) -> torch.Tensor:
        return torch.tanh(u) * self._scale + self._mid

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise``: standard-normal draws of the mean's shape; drawn from
        ``generator`` when not given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device)
        return self._squash(self.mean + torch.exp(self.log_std) * noise)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        y = torch.clamp((value - self._mid) / self._scale,
                        -1 + 1e-6, 1 - 1e-6)
        u = torch.atanh(y)
        std = torch.exp(self.log_std)
        base = (-0.5 * ((u - self.mean) / std) ** 2
                - self.log_std - 0.5 * math.log(2 * math.pi))
        # |d value / d u| = scale * (1 - tanh(u)^2)
        log_det = torch.log(self._scale) + torch.log1p(-(y ** 2))
        return (base - log_det).sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        """The base Gaussian's entropy, summed over the action dimensions
        of ``log_std`` (no squash correction, as in the JAX package)."""
        return (self.log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(
            dim=-1)

    def mode(self) -> torch.Tensor:
        return self._squash(self.mean)
