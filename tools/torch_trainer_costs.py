#!/usr/bin/env python3
"""Costs of two parts of the port that ``chip_smoke.py`` runs once, on one
GPU.

    python3 tools/torch_trainer_costs.py            # both parts
    python3 tools/torch_trainer_costs.py --env-info
    python3 tools/torch_trainer_costs.py --composed

``--env-info``: on ``configs/ippo_2player.yaml``'s world (4,096 envs),
first one step's info reduction alone (``rl/ppo.py::_reduce_info`` on the
info of a real step: host ms a call over 200 calls, then the card's
kernels a call from ``torch.profiler``, beside a bare ``step_vec``), then
2 updates at a time of training with ``LOG_ENV_INFO`` on and off in turns
(on, off, on, off, on, off) in one process, one world; prints each run's
rollout and PPO seconds, so the on/off difference can be set against the
spread.

``--composed``: the ``composed`` route of the fused blocks
(``ops/block_kernel.py``: the plain versions with the XLA-form attention)
op by op at ViT-Base's and ViT-Small's widths (B=1,024 images, N=11,
bf16): a product as the route takes it (operands widened to float32, no
TF32) beside the same product in bf16 with float32 sums (a route that
rounded each product before its bias would take that) and, where the
card's torch has ``torch.mm(..., out_dtype=torch.float32)``, in bf16 with
a float32 output; then LN, the XLA-form attention, GELU and the whole
block; ms a call, CUDA events over 20 calls after 3 untimed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def reduce_costs(env, n_envs, calls=200):
    """Host ms a call of one step's info reduction and of a bare step, and
    the card's kernels a call of each (``torch.profiler``)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vit_marl_tpu_torch.env import spaces
    from vit_marl_tpu_torch.rl.ppo import _reduce_info

    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = env.default_params
    _, state = env.reset(env.draw_reset(n_envs, gen), params)

    def actions():
        out = []
        for sp, n in zip(env.action_spaces, env.n_per_type):
            lead = (n_envs,) if n == 1 else (n_envs, n)
            if isinstance(sp, spaces.Discrete):
                out.append(torch.randint(sp.n, lead, generator=gen,
                                         device=dev))
            else:
                u = torch.rand(lead + tuple(sp.shape), generator=gen,
                               device=dev)
                out.append(sp.low.to(dev) + u * (sp.high - sp.low).to(dev))
        return out

    def step():
        nonlocal state
        _, state, _, _, info = env.step_vec(state, actions(), params,
                                            generator=gen)
        return info

    info = step()
    rows = {"one step's info reduction": lambda: _reduce_info(info),
            "bare step_vec": step}
    for name, fn in rows.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        n = calls if fn is not step else 20
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events()
                      if e.device_type.name == "CUDA")
        print(f"{name}: host {1e3 * host / n:.4f} ms a call, until the "
              f"card is done {1e3 * wall / n:.4f} ms a call ({n} calls); "
              f"card kernels a call (torch.profiler) {kernels}", flush=True)


def env_info_costs():
    from vit_marl_tpu_torch.config import load_yaml_config
    from vit_marl_tpu_torch.rl.ppo import make_train

    ma, tc = load_yaml_config(os.path.join(ROOT, "configs",
                                           "ippo_2player.yaml"))
    tc = dataclasses.replace(tc, log_backend="none")
    env = make_train(ma, tc, device="cuda").env
    reduce_costs(env, tc.num_envs)
    for flag in (True, False, True, False, True, False):
        train = make_train(ma, dataclasses.replace(tc, log_env_info=flag),
                           env=env)
        out = train(tc.seed, n_updates=2)
        print(f"LOG_ENV_INFO={'on' if flag else 'off'}: rollout "
              + " / ".join(f"{m['rollout_s']:.3f}" for m in out["metrics"])
              + " s, PPO "
              + " / ".join(f"{m['update_s']:.3f}" for m in out["metrics"])
              + " s", flush=True)


def composed_costs():
    import torch
    import torch.nn.functional as F

    from vit_marl_tpu_torch.ops import block_kernel as blk
    from vit_marl_tpu_torch.ops.attention_kernel import (
        attention_reference_xla,
    )
    from vit_marl_tpu_torch.selfcheck import block_params

    def ms(fn, n=20):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    N, B = 11, 1024
    names = ("g1", "b1", "wqkv", "bqkv", "wp", "bp", "g2", "b2", "w1",
             "bm1", "w2", "bm2")
    for W, H in ((768, 12), (384, 6)):
        p = block_params(gen, torch.bfloat16, W, 4 * W)
        x = torch.randn((B * N, W), generator=gen, device=dev).to(
            torch.bfloat16)
        qkv = F.linear(x, p["wqkv"])
        h = F.linear(x, p["w1"])
        rows = {
            "qkv product, float32 operands": lambda: blk.dense(
                x, p["wqkv"], p["bqkv"]),
            "qkv product, bf16": lambda: F.linear(x, p["wqkv"]),
            "mlp1 product, float32 operands": lambda: blk.dense(
                x, p["w1"], p["bm1"]),
            "mlp1 product, bf16": lambda: F.linear(x, p["w1"]),
            "LN": lambda: blk.layer_norm(x, p["g1"], p["b1"]).to(x.dtype),
            "XLA-form attention": lambda: attention_reference_xla(qkv, N,
                                                                  H),
            "GELU": lambda: blk.gelu(h),
            "whole block": lambda: blk._full_block_xla(
                x, *[p[k] for k in names], N, H),
        }
        try:     # bf16 products with a float32 output, where torch has it
            torch.mm(x[:8], p["wqkv"][:8].t(), out_dtype=torch.float32)
            rows["qkv product, bf16 to float32 output"] = lambda: torch.mm(
                x, p["wqkv"].t(), out_dtype=torch.float32)
        except (TypeError, RuntimeError, NotImplementedError) as e:
            print(f"torch.mm(..., out_dtype=float32): {e}".splitlines()[0])
        with torch.no_grad():
            print(f"W={W}, B={B}: " + "; ".join(
                f"{k} {ms(f):.4f} ms" for k, f in rows.items()), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-info", action="store_true")
    p.add_argument("--composed", action="store_true")
    args = p.parse_args(argv)
    both = not (args.env_info or args.composed)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.composed or both:
        composed_costs()
    if args.env_info or both:
        env_info_costs()


if __name__ == "__main__":
    main()
