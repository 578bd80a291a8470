#!/usr/bin/env python3
"""Does update 0 repeat?  On one GPU, one config, one world: update 0 of
a fresh trainer, from the same seed, twice under ``ROLLOUT_MODE=loop`` and
twice under ``scan`` (the rollout as a CUDA graph, ``rl/scan.py``), first
with cuDNN free to pick non-deterministic algorithms (the default), then
with ``torch.backends.cudnn.deterministic`` set.  Prints, for each pair,
the metrics that differ (timing metrics left out).

    python3 tools/torch_scan_repeat.py                       # cnn_gru
    python3 tools/torch_scan_repeat.py --config configs/ippo_2player.yaml \\
        --set NUM_ENVS=1024

Default: ``configs/ippo_vision_dual_ppo.yaml`` on ``NETWORK=[gru,
cnn_gru]`` (1,024 envs), the config whose update 0 differed between the
two modes while the rollouts were bit-equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIMES = ("rollout_s", "update_s")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config",
                   default=os.path.join(ROOT, "configs",
                                        "ippo_vision_dual_ppo.yaml"))
    p.add_argument("--set", action="append", default=None)
    a = p.parse_args()
    sets = a.set if a.set is not None else ["NETWORK=[gru, cnn_gru]"]
    import torch
    import yaml

    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.rl.ppo import make_train
    from vit_marl_tpu_torch.utils.cli import apply_set_overrides

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(a.config) as f:
        raw = yaml.safe_load(f)
    ma, tc = make_config(apply_set_overrides(raw, sets + [
        "LOG_BACKEND=none"]))
    env = WorldEnv(ma, device="cuda")

    def update0(mode):
        train = make_train(ma, dataclasses.replace(tc, rollout_mode=mode),
                           env=env)
        m = train(tc.seed, n_updates=1)["metrics"][0]
        torch.cuda.synchronize()
        return {k: v for k, v in m.items() if k not in TIMES}

    def differ(x, y):
        return sorted(k for k in set(x) | set(y) if x.get(k) != y.get(k))

    print(f"{os.path.basename(a.config)} {sets}, {tc.num_envs} envs x "
          f"{tc.num_steps} steps [{smi}]", flush=True)
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        runs = {f"{mode} {i}": update0(mode)
                for mode in ("loop", "scan") for i in (1, 2)}
        for x, y in (("loop 1", "loop 2"), ("scan 1", "scan 2"),
                     ("loop 1", "scan 1")):
            d = differ(runs[x], runs[y])
            print(f"cudnn.deterministic={det}: {x} against {y}: "
                  + (f"differ in {d}: "
                     + ", ".join(f"{k} {runs[x].get(k)!r} / "
                                 f"{runs[y].get(k)!r}" for k in d)
                     if d else f"equal in all {len(runs[x])} metrics"),
                  flush=True)


if __name__ == "__main__":
    main()
