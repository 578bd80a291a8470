"""Profiling helpers (port of ``vit_marl_tpu/utils/profiling.py``; ref:
ad-hoc jax.profiler usage, base_env.py:455-472, ippo_rnn_JAXMARL.py:795-802).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from vit_marl_tpu_torch.utils.tree import tree_leaves


# the profiler now and then loses the records of the last kernels before
# it stops, although the card has finished them (a CUDA graph's replays
# traced on an NVIDIA H100 80GB HBM3 lost up to the last 5 steps' kernels
# of 128; tools/torch_trace_loss.py): with ``drain``, DRAIN spin kernels
# and DRAIN_S seconds of sleep after the block let those records arrive,
# and :func:`kernel_events` leaves the spin kernels out
DRAIN, DRAIN_S, DRAIN_KERNEL = 2048, 0.2, "spin_kernel"


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "torch-trace"),
          drain: bool = False):
    """Capture a ``torch.profiler`` trace around a block: CPU activity, and
    CUDA activity where a card is present.  Yields the profiler (read its
    ``key_averages()`` after the block); on exit writes a Chrome trace to
    ``log_dir`` (its path is the profiler's ``trace_path``; view it in
    chrome://tracing or Perfetto).  ``drain``: end the trace with the
    drain (DRAIN) where a card is present."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if drain and cuda:
            torch.cuda.synchronize()
            for _ in range(DRAIN):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(DRAIN_S)
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def kernel_events(trace_path: str):
    """The device kernels of a Chrome trace that :func:`trace` wrote (events
    with ``ts`` and ``dur`` in us, ``name`` and ``args``), the drain's spin
    kernels left out."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [ev for ev in events if ev.get("cat") == "kernel" and "dur" in ev
            and DRAIN_KERNEL not in ev.get("name", "")]


@contextlib.contextmanager
def timed(label: str, sync=None):
    """Wall-clock a block and print it.  ``sync``: a tensor or a tree of
    tensors whose devices are synchronised before the clock is read, so
    the time covers the work queued on a card (the JAX package's
    ``block_until_ready``)."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        for dev in {x.device for x in tree_leaves(sync)
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(dev)
    print(f"[{label}] {time.perf_counter() - t0:.4f}s")


L2_FLUSH_BYTES = 128 << 20      # more than an H100's 50 MB of L2


def median_ms(fn, device: torch.device, reps: int = 10, inner: int = 4):
    """Median ms a call of ``fn()`` over ``reps`` batches of ``inner``
    back-to-back calls, after two warm-up calls.  On a card: CUDA events
    around each batch, the L2 flushed (a 128 MiB write) before it; on the
    CPU the host clock.  Inputs stay as they are: a CUDA stream runs every
    launch it is given, and its events time them (the JAX package's
    ``tools/profile_vit.py::timed`` perturbs its inputs and fetches one
    scalar to get past a remote relay that dedupes identical executions
    and whose syncs return early; neither applies here)."""
    for _ in range(2):
        fn()
    times = []
    if device.type == "cuda":
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def device_label(device: torch.device) -> str:
    """What a run's times were taken on: the card's name and its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them,
    or the CPU (whose times say nothing of a card)."""
    if device.type != "cuda":
        return "# device=cpu (the plain versions; a smoke run, no card time)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return f"# device={torch.cuda.get_device_name(device)} [{smi}]"
