"""Action and observation spaces (port of ``vit_marl_tpu/env/spaces.py``,
shapes and bounds only: the port samples actions from its policies)."""

from __future__ import annotations

from typing import Mapping, Tuple

import torch


class Discrete:
    def __init__(self, n: int):
        self.n = n
        self.shape: Tuple[int, ...] = ()
        self.dtype = torch.int32

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    """Bounds are scalars or per-dimension tensors of ``shape``."""

    def __init__(self, low, high, shape: Tuple[int, ...],
                 dtype=torch.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"Box(shape={self.shape})"


class Dict:
    """Named sub-spaces, e.g. ``{"obs", "vision_obs"}``."""

    def __init__(self, spaces: Mapping[str, object]):
        self.spaces = dict(spaces)

    def __repr__(self):
        return f"Dict({self.spaces})"
