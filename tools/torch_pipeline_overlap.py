#!/usr/bin/env python3
"""Whether the two-stream pipelined rollout overlaps its halves on one
GPU.

    python3 tools/torch_pipeline_overlap.py [--envs 4096] [--rounds 3]

On the bench's world with ViT-Small policies (``vit_marl_tpu_torch/
bench.py``, 10 steps x 2 reps after one untimed run, each measurement
building its world anew): ``pipeline-seq`` (the split-batch schedule on
one CUDA stream) and ``pipeline`` (each tick's env half and policy half
on two streams) in turns, seq, two-stream, two-stream, seq, for
``--rounds`` rounds, and ``loop`` once a round; prints each rate.  Then
one run of each pipelined mode under ``torch.profiler`` (5 steps x 2
reps after one untimed run): over the later half of the traced kernels
(the timed runs, the world's set-up left out), the card's kernel time by
stream (the pipelined runner takes two new streams a run), the time
kernels of two streams ran at once, the busy and idle
shares of that window (the union of kernel intervals over its span),
and the host's seconds for the whole call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def concurrent(by_stream):
    """Time during which kernels of two or more streams ran at once (each
    stream's busy time summed, less the busy time of all: exact where at
    most two streams overlap, more where three do)."""
    allk = [iv for ivs in by_stream.values() for iv in ivs]
    return sum(union(ivs) for ivs in by_stream.values()) - union(allk)


def traced(torch, fn):
    """``fn()`` under ``utils/profiling.py::trace`` with its drain: its
    kernels' intervals by stream (us) from the Chrome trace, the host's
    seconds, and the kernels launched, counted by name (a CUDA graph's
    replays included); the drain left out."""
    import time

    from vit_marl_tpu_torch.utils.profiling import kernel_events, trace

    with tempfile.TemporaryDirectory() as d:
        with trace(d, drain=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
        events = kernel_events(prof.trace_path)
    by_stream, names = {}, {}
    for ev in events:
        s = ev.get("args", {}).get("stream", ev.get("tid"))
        by_stream.setdefault(s, []).append(
            (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        names[ev.get("name", "")] = names.get(ev.get("name", ""), 0) + 1
    return by_stream, host, names


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args()
    import torch

    from vit_marl_tpu_torch import bench

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)

    def args_for(mode, steps=10, reps=2):
        return bench.parse_args(["--envs", str(a.envs), "--steps",
                                 str(steps), "--reps", str(reps),
                                 "--policy", "vit-small", "--mode", mode])

    bench.measure(args_for("pipeline", 2, 1), dev)       # builds, warms
    rates = {"loop": [], "pipeline-seq": [], "pipeline": []}
    for r in range(a.rounds):
        for mode in ("pipeline-seq", "pipeline", "pipeline", "pipeline-seq",
                     "loop"):
            v = bench.measure(args_for(mode), dev)["value"]
            rates[mode].append(v)
            print(f"round {r}: {mode} {v:.1f} env-steps/s [{smi}]",
                  flush=True)
    for mode, vs in rates.items():
        print(f"{mode}: {', '.join(f'{v:.1f}' for v in vs)} env-steps/s "
              f"[{smi}]", flush=True)
    for mode in ("pipeline-seq", "pipeline"):
        by_stream, host, _ = traced(
            torch, lambda: bench.measure(args_for(mode, 5, 2), dev))
        starts = sorted(x for ivs in by_stream.values() for x, _ in ivs)
        cut = starts[len(starts) // 2]
        by_stream = {k: [iv for iv in v if iv[0] >= cut]
                     for k, v in by_stream.items()}
        by_stream = {k: v for k, v in by_stream.items() if v}
        allk = [iv for ivs in by_stream.values() for iv in ivs]
        window = max(b for _, b in allk) - min(x for x, _ in allk)
        busy = union(allk)
        streams = sorted(by_stream, key=lambda s: -len(by_stream[s]))
        overlap = concurrent(by_stream)
        per = ", ".join(f"stream {s}: {len(by_stream[s])} kernels, "
                        f"{union(by_stream[s]) / 1e3:.1f} ms"
                        for s in streams)
        print(f"{mode} traced (the later half of 3 runs of 5 steps, "
              f"{a.envs} envs): {per}; "
              f"two streams at once {overlap / 1e3:.2f} ms; kernel window "
              f"{window / 1e3:.1f} ms, busy {busy / window:.3f}, idle "
              f"{1 - busy / window:.3f}; host {host:.2f} s [{smi}]",
              flush=True)


if __name__ == "__main__":
    main()
