"""Throughput grid of the world's step (port of
``vit_marl_tpu/eval/speed_test.py``; ref: gymnax_exchange/jaxen/
Speed_test.py:41-276).

Sweeps agents per type x data messages per step over batched worlds with
zero actions, and reports env-steps/s per configuration: the host issues
``step_vec`` once a step, and the clock reads after the device has
finished.  Rows carry the JAX package's keys; ``csv_path`` writes them.

    python -m vit_marl_tpu_torch.eval.speed_test [--csv PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import time
from typing import List, Optional, Sequence, Tuple

import torch

from vit_marl_tpu_torch.config import (
    ExecutionConfig,
    MarketMakingConfig,
    MultiAgentConfig,
    WorldConfig,
)
from vit_marl_tpu_torch.env.world import make_world_env
from vit_marl_tpu_torch.utils.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_speed_grid(
    agents_grid: Sequence[Tuple[int, int]] = ((1, 1), (5, 5), (10, 10)),
    n_data_msgs: Sequence[int] = (100, 1),
    num_envs: int = 4096,
    num_steps: int = 50,
    csv_path: Optional[str] = None,
    device=None,
) -> List[dict]:
    """One row a (agents, data messages) configuration: its shape,
    ``msgs_per_step``, the timed loop's seconds and env-steps/s.  Runs on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    rows = []
    for n_mm, n_exec in agents_grid:
        for n_msg in n_data_msgs:
            wcfg = WorldConfig(n_data_msg_per_step=max(n_msg, 1),
                               ep_type="fixed_steps", episode_time=num_steps,
                               start_resolution=num_steps,
                               n_orders=128, n_trades=128,
                               n_messages_per_synthetic_day=max(
                                   30_000, n_msg * num_steps * 10))
            ma = MultiAgentConfig(
                world=wcfg,
                agents=(MarketMakingConfig(), ExecutionConfig()),
                n_agents_per_type=(n_mm, n_exec))
            env = make_world_env(ma, device=dev)
            params = env.default_params
            gen = torch.Generator(device=dev).manual_seed(0)
            _, state = env.reset(env.draw_reset(num_envs, gen), params)
            actions = [torch.zeros((num_envs, n) if n > 1 else (num_envs,),
                                   dtype=torch.int32, device=dev)
                       for n in (n_mm, n_exec)]
            out = env.step_vec(state, actions, params, generator=gen)
            float(out[2][0].sum())
            _sync(dev)
            t0 = time.perf_counter()
            st = state
            for _ in range(num_steps):
                _, st, rew, _, _ = env.step_vec(st, actions, params,
                                                generator=gen)
            float(rew[0].sum())
            float(st.world.mid_price.float().sum())
            _sync(dev)
            dt = time.perf_counter() - t0
            rows.append({
                "n_mm": n_mm, "n_exec": n_exec, "n_data_msg": n_msg,
                "num_envs": num_envs, "num_steps": num_steps,
                "msgs_per_step": env.num_msgs_per_step,
                "seconds": round(dt, 3),
                "env_steps_per_sec": round(num_envs * num_steps / dt, 1),
            })
            print(json.dumps(rows[-1]), flush=True)
    if csv_path:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--csv", default=None,
                   help="write the rows to this CSV file")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run_speed_grid(csv_path=args.csv, device=args.device)


if __name__ == "__main__":
    main()
