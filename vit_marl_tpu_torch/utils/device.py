"""Device selection for the port's entry points, and constants on a
device."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    Entry points run on the card: with ``device=None`` this is ``cuda``, and
    without a usable card it raises instead of falling back.  The CPU is
    used only when the caller asks for it (``device="cpu"``, as the tests
    do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _const(values, dtype: Optional[torch.dtype],
           device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept: a read-only table or scalar that the
    env step reads without a host-to-device copy each step, which a CUDA
    graph could not capture.  ``values``: a number or nested lists of
    numbers; ``dtype=None`` infers it as ``torch.tensor`` does.  A tensor
    ``values`` is moved and cast as ``torch.as_tensor`` does."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=dtype or values.dtype)
    return _const(_frozen(values), dtype, torch.device(device))
