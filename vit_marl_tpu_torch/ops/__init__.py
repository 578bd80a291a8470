"""The port's hand-written kernels (``csrc/``) and their wrappers.

Each wrapper counts its kernel's launches in attributes of the public
function (``process_step_aggs.launches``, ``short_attention.launches_fwd``,
``fused_block_full.launches_wgmma``, ...) through :func:`tally`.
"""

from __future__ import annotations

import torch


def tally(t: torch.Tensor, fn, *fields: str) -> None:
    """Add one to each counter ``fields`` of ``fn`` for a call on ``t``'s
    device.  A call on a CUDA stream that is being captured into a graph
    launches nothing: it records the launch, which each replay of the
    graph then makes without the wrapper.  Such a call is not counted; a
    profiler trace of the replays counts their launches."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    for f in fields:
        setattr(fn, f, getattr(fn, f) + 1)
