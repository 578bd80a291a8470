#!/usr/bin/env python3
"""Does a ``torch.profiler`` trace hold every kernel that a CUDA graph's
replays launch, with and without the drain of ``traced``?

    python3 tools/torch_trace_loss.py [--envs 1024] [--reps 4]

On ``configs/ippo_vision_dual_ppo.yaml`` (one PPO epoch, logging off): the
rollout as a CUDA graph (``rl/scan.py::ScanRollout``), captured once, then
traced ``--reps`` times in each of two ways, in turns:

- ``plain``: the profiler stops right after a synchronize;
- ``drained``: ``tools/torch_pipeline_overlap.py::traced``, which traces
  with ``vit_marl_tpu_torch/utils/profiling.py::trace(drain=True)``: the
  traced work is followed by its drain (``DRAIN`` spin kernels, a
  synchronize and ``DRAIN_S`` of sleep) before the profiler stops, and the
  spin kernels are left out.

For each trace: the book-scan and short-attention records against the
graph's nodes (its DOT dump) x NUM_STEPS, and all kernel records.  First,
the names of the kernels that a drain alone leaves in a trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tools"))


def trace(torch, fn):
    """``fn()`` under the profiler, stopped right after a synchronize:
    kernel records by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = json.load(f)
    names = {}
    for ev in tr.get("traceEvents", []):
        if ev.get("cat") == "kernel" and "dur" in ev:
            names[ev.get("name", "")] = names.get(ev.get("name", ""), 0) + 1
    return names


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--reps", type=int, default=4)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl import ppo as tppo
    from vit_marl_tpu_torch.rl.scan import ScanRollout

    import torch_pipeline_overlap as tpo
    from vit_marl_tpu_torch.utils import profiling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    for m in (bkern, attn):
        m.build_library()
        m._library()
    dev = "cuda"
    ma, tc = cs.config_with(
        os.path.join(ROOT, "configs", "ippo_vision_dual_ppo.yaml"),
        [f"NUM_ENVS={a.envs}", "LOG_BACKEND=none", "UPDATE_EPOCHS=1"])
    env = WorldEnv(ma, device=dev)
    E, T = tc.num_envs, tc.num_steps
    torch.manual_seed(tc.seed)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tc.seed)
    params = env.default_params
    obs, state = env.reset(env.draw_reset(E, gen), params)
    actors = [n * E for n in env.n_per_type]
    carry = tppo.Carry(state, obs, [torch.zeros(n, dtype=torch.bool,
                                                device=dev) for n in actors],
                       [torch.zeros(n, tc.hidden_size, device=dev)
                        for n in actors])
    scan = ScanRollout(env.step_vec, nets, params, T, E, env.n_per_type,
                       gen, gen, tc.log_env_info, dev)

    def rollout():
        nonlocal carry
        with torch.no_grad():
            _, _, carry = scan.run(carry)

    rollout()
    torch.cuda.synchronize()
    nodes = cs.graph_nodes(scan.graph)
    want = {f: n * T for f, n in nodes.items()}
    spin = profiling.DRAIN_KERNEL
    drain = trace(torch, lambda: [torch.cuda._sleep(1)
                                  for _ in range(profiling.DRAIN)])
    print(f"a drain alone: {drain}; left out by name: "
          f"{sum(c for n, c in drain.items() if spin in n)} "
          f"of {profiling.DRAIN}", flush=True)
    ways = {"plain": lambda: trace(torch, rollout),
            "drained": lambda: tpo.traced(torch, rollout)[2]}
    print(f"{E} envs x {T} steps; the graph's hand-written nodes {nodes}, "
          f"launched {T} times: want {want} [{smi}]", flush=True)
    for r in range(a.reps):
        for way, fn in ways.items():
            names = fn()
            fams = {}
            for n, c in names.items():
                f = cs.kernel_family(n)
                if f:
                    fams[f] = fams.get(f, 0) + c
            print(f"rep {r} {way}: traced {fams}, want {want}; "
                  f"{sum(names.values())} kernel records, "
                  f"{sum(c for n, c in names.items() if spin in n)}"
                  f" of them spin kernels [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
