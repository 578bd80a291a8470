"""Action and observation spaces (port of ``vit_marl_tpu/env/spaces.py``).

``sample(generator)`` draws one element from a ``torch.Generator``, on its
device, with the JAX package's bounds: ``Discrete(n)`` and an integer
``Box`` uniformly from ``[low, high)`` (``jax.random.randint``), a float
``Box`` from ``[low, high)`` (``jax.random.uniform``).  The draws differ
from the JAX package's threefry streams.  ``contains(x)`` is the JAX
package's test: ``0 <= x < n``, or ``low <= x <= high`` everywhere.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch


class Space:
    def sample(self, generator: torch.Generator):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = n
        self.shape: Tuple[int, ...] = ()
        self.dtype = torch.int32

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randint(0, self.n, (), generator=generator,
                             device=generator.device, dtype=self.dtype)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        return bool(((x >= 0) & (x < self.n)).all())

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    """Bounds are scalars or per-dimension tensors of ``shape``."""

    def __init__(self, low, high, shape: Tuple[int, ...],
                 dtype=torch.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    def _bounds(self, device):
        wide = torch.float64
        return (torch.as_tensor(self.low, dtype=wide, device=device),
                torch.as_tensor(self.high, dtype=wide, device=device))

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        dev = generator.device
        u = torch.rand(self.shape, generator=generator, device=dev,
                       dtype=torch.float64)
        low, high = self._bounds(dev)
        if self.dtype.is_floating_point:
            lo = low.to(self.dtype)
            return torch.maximum(lo, (u.to(self.dtype) * (high - low).to(
                self.dtype) + lo))
        return (low + torch.floor(u * (high - low))).to(self.dtype)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        low, high = self._bounds(x.device)
        x = x.to(torch.float64)
        return bool((x >= low).all() & (x <= high).all())

    def __repr__(self):
        return f"Box(shape={self.shape})"


class Dict(Space):
    """Named sub-spaces, e.g. ``{"obs", "vision_obs"}``."""

    def __init__(self, spaces: Mapping[str, Space]):
        self.spaces = dict(spaces)
        self.shape = {k: s.shape for k, s in self.spaces.items()}

    def sample(self, generator: torch.Generator) -> dict:
        return {k: s.sample(generator) for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return all(s.contains(x[k]) for k, s in self.spaces.items())

    def __repr__(self):
        return f"Dict({self.spaces})"
