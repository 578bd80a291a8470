"""Benchmark: env-steps/s of the world with a policy in the loop, on the card.

Counterpart of the JAX package's ``bench.py::main``: the 2-player world
(``spread_skew`` market maker and an execution agent, the book scan every
step) with the policies' forward and sampling in the rollout loop.  Prints
ONE JSON line on stdout,

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null}

and ``# device=... envs=... compile=... run=...`` on stderr.
``vs_baseline`` is null: the JAX bench's 1e6 env-steps/s is a target set
for a TPU and is not carried over.  Without a card (and without
``--device cpu``), or when ``--deadline`` passes, it prints the same line
with ``"value": 0.0`` and an ``"error"`` and exits non-zero.

Usage:
  python -m vit_marl_tpu_torch.bench                      # vit-small, 8192
  python -m vit_marl_tpu_torch.bench --policy gru --envs 4096
  python -m vit_marl_tpu_torch.bench --vit-images         # ViT fwd+bwd
  python -m vit_marl_tpu_torch.bench --selfcheck          # kernels vs plain
  python -m vit_marl_tpu_torch.bench --smoke --device cpu

``--mode``: ``loop`` (Python-issued steps), ``scan`` (the trainer's
rollout of ``rl/scan.py``, one CUDA graph of the step replayed
``--steps`` times: the counterpart of the JAX bench's fused ``lax.scan``;
it needs a card, and on the CPU prints the error line and exits
non-zero), ``pipeline`` (the split-batch pipelined rollout of
``rl/pipeline.py``, each tick's env half and policy half on two CUDA
streams) and ``pipeline-seq`` (the same schedule on one stream).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import threading
import time

import torch

PRESETS = {"none": "small", "gru": "small", "vit-tiny": "tiny",
           "vit-small": "small", "vit-base": "base"}


def _error_json(metric: str, reason: str, unit: str) -> str:
    return json.dumps({"metric": metric, "value": 0.0, "unit": unit,
                       "vs_baseline": None, "error": reason})


def arm_deadline(metric: str, seconds: float, unit: str):
    """If the bench has not finished ``seconds`` after arming, print the
    error line and end the process."""
    def fire():
        print(_error_json(metric, f"bench_deadline_exceeded: no result "
                                  f"after {seconds}s", unit), flush=True)
        os._exit(3)
    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m vit_marl_tpu_torch.bench")
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--data-msgs", type=int, default=100)
    p.add_argument("--policy", default="vit-small", choices=list(PRESETS))
    p.add_argument("--vit-images", action="store_true",
                   help="ViT fwd+bwd images/s of one PPO minibatch step")
    p.add_argument("--selfcheck", action="store_true",
                   help="every CUDA kernel against its plain version at "
                        "the bench's shapes, then exit")
    p.add_argument("--mode", default="loop",
                   choices=["loop", "scan", "pipeline", "pipeline-seq"])
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes: 8 envs, 4 steps, 1 rep, 10 msgs")
    p.add_argument("--fused-block", action="store_true")
    p.add_argument("--fused-block-full", action="store_true")
    p.add_argument("--attn-kernel", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--attn-bwd-kernel",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--attn-ln-fold", action="store_true")
    p.add_argument("--deadline", type=float, default=1500.0,
                   help="wall-clock budget in seconds")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu on request)")
    args = p.parse_args(argv)
    if args.smoke:
        args.envs, args.steps, args.reps, args.data_msgs = 8, 4, 1, 10
    return args


def _vit_config(args, preset: str):
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS
    return dataclasses.replace(
        VIT_PRESETS[preset], fused_block=args.fused_block,
        fused_block_full=args.fused_block_full,
        attn_kernel=args.attn_kernel, attn_bwd_kernel=args.attn_bwd_kernel,
        attn_ln_fold=args.attn_ln_fold)


def metric_label(args):
    """(metric, unit), as ``bench.py`` labels them (``bench.py:150-211``).
    A fused mode whose kernels do not take the preset's width runs the
    composed route (``ops/block_kernel.py::fits_kernel``) and says so."""
    from vit_marl_tpu_torch.ops.block_kernel import fits_kernel

    preset = PRESETS[args.policy]
    vit = _vit_config(args, preset)
    W, hidden = vit.width, vit.width * vit.mlp_ratio
    vit_measured = args.vit_images or args.policy.startswith("vit")
    tag = ""
    if vit_measured and args.fused_block_full:
        tag = ",fusedblockfull" + (
            "" if fits_kernel("fused_block_full", W, hidden) else ":composed")
    elif vit_measured and args.fused_block:
        tag = ",fusedblock" + (
            "" if fits_kernel("fused_ln_qkv", W, 3 * W)
            and fits_kernel("fused_proj_mlp", W, hidden) else ":composed")
    if vit_measured and not args.attn_kernel:
        tag += ",xla-attn"
    if vit_measured and args.attn_ln_fold:
        tag += ",lnfold" + ("" if fits_kernel("fused_ln_qkv_attn", W)
                            else ":composed")
    if args.vit_images:
        if args.attn_kernel and not args.attn_bwd_kernel:
            tag += ",xla-bwd"
        return f"vit_fwd_bwd_images_per_sec[{preset}{tag}]", "images/s"
    if args.selfcheck:
        return "kernel_selfcheck_ok", "bool"
    return (f"env_steps_per_sec_per_chip[{args.policy}{tag},{args.mode}]",
            "env-steps/s")


@functools.lru_cache(maxsize=None)
def _day_data(wcfg):
    """The synthetic days of a world config, made once a process."""
    from vit_marl_tpu_torch.data.lobster import load_data
    return load_data(wcfg)


def bench_world(args, device):
    """The bench's world (``bench.py:240-256``) on ``device``."""
    from vit_marl_tpu_torch.config import (
        ExecutionConfig,
        MarketMakingConfig,
        MultiAgentConfig,
        WorldConfig,
    )
    from vit_marl_tpu_torch.env.world import WorldEnv

    vision = args.policy.startswith("vit")
    wcfg = WorldConfig(
        n_data_msg_per_step=args.data_msgs, ep_type="fixed_steps",
        episode_time=50, start_resolution=50, n_orders=128, n_trades=128,
        n_messages_per_synthetic_day=max(30_000, args.data_msgs * 60 * 4))
    ma = MultiAgentConfig(
        world=wcfg,
        agents=(MarketMakingConfig(action_space="spread_skew"),
                ExecutionConfig(
                    action_space=("policy_blending" if vision
                                  else "fixed_quants_complex"),
                    observation_space=("execution_policy" if vision
                                       else "engineered"),
                    reward_space="dual_ppo" if vision else "normal",
                    use_vision_obs=vision)),
        n_agents_per_type=(1, 1))
    return WorldEnv(ma, data=_day_data(wcfg), device=device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench_setup(args, dev):
    """The bench's world, reset at ``args.envs`` envs, and its policies
    (none, or one network a type at the preset) with zero GRU carries;
    draws from a generator seeded 0."""
    from vit_marl_tpu_torch.config import TrainConfig
    from vit_marl_tpu_torch.models.rnn import ScannedGRU
    from vit_marl_tpu_torch.rl.ppo import make_network

    E = args.envs
    env = bench_world(args, dev)
    params = env.default_params
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.manual_seed(0)
    obs, state = env.reset(env.draw_reset(E, gen), params)
    n_types = len(env.agent_types)
    nets, hs = [], []
    if args.policy != "none":
        use_vision = args.policy.startswith("vit")
        vit = _vit_config(args, PRESETS[args.policy])
        tc = TrainConfig(
            num_envs=E,
            network=("gru", "vit_gru") if use_vision else ("gru", "gru"),
            vit_preset=PRESETS[args.policy],
            vit_fused_block=vit.fused_block,
            vit_fused_block_full=vit.fused_block_full,
            vit_attn_kernel=vit.attn_kernel,
            vit_attn_bwd_kernel=vit.attn_bwd_kernel,
            vit_attn_ln_fold=vit.attn_ln_fold)
        nets = [make_network(tc, i, env.action_spaces[i],
                             env.observation_spaces[i]).to(dev)
                for i in range(n_types)]
        hs = [ScannedGRU.initialize_carry(E, tc.hidden_size, dev)
              for _ in range(n_types)]
    return env, params, gen, obs, state, nets, hs


def _policy_actions(nets, hs, obs, n: int, gen):
    """Each network's sampled action for ``n`` envs of one step, no
    resets (``bench.py::policy_actions``); updates ``hs`` in place."""
    from vit_marl_tpu_torch.utils.tree import tree_map

    no_done = torch.zeros((1, n), dtype=torch.bool, device=hs[0].device)
    acts = []
    for i, net in enumerate(nets):
        o = tree_map(lambda v: v.reshape((n,) + v.shape[2:])[None], obs[i])
        hs[i], pi, _ = net(hs[i], o, no_done)
        acts.append(pi.sample(gen)[0])
    return acts


def bench_loop(args, dev) -> dict:
    """Env-steps/s: policy forward, sample and ``step_vec``, one untimed
    step, then ``reps x steps`` timed steps (``bench.py:333-338``)."""
    from vit_marl_tpu_torch.env import spaces

    E = args.envs
    env, params, gen, obs, state, nets, hs = _bench_setup(args, dev)
    if not nets:
        fixed = [torch.zeros(E, dtype=torch.int64, device=dev)]
        sp = env.action_spaces[1]
        fixed.append(torch.ones(E, dtype=torch.int64, device=dev)
                     if isinstance(sp, spaces.Discrete)
                     else torch.full((E, 3), 0.5, device=dev))

    def one_step(state, obs):
        acts = _policy_actions(nets, hs, obs, E, gen) if nets else fixed
        obs, state, rew, _, _ = env.step_vec(state, acts, params,
                                             generator=gen)
        return state, obs, rew[0]

    with torch.no_grad():
        t0 = time.perf_counter()
        state, obs, rew = one_step(state, obs)
        _sync(dev)
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps * args.steps):
            state, obs, rew = one_step(state, obs)
        _sync(dev)
        float(rew.sum())
        dt = time.perf_counter() - t0
    return dict(value=E * args.steps * args.reps / dt, compile=compile_time,
                run=dt, detail=f"envs={E} steps={args.steps} "
                f"reps={args.reps} msgs/step={env.num_msgs_per_step}")


def bench_pipeline(args, dev) -> dict:
    """Env-steps/s of the split-batch pipelined rollout
    (``bench.py:346-397``, ``rl/pipeline.py``): ``--mode pipeline`` issues
    each tick's env half and policy half on two CUDA streams,
    ``pipeline-seq`` the same schedule on one.  One untimed run of
    ``steps`` steps, then ``reps`` timed runs.  ``final`` holds the last
    run's observations of both halves and every step's actions, for
    comparing the two modes."""
    from vit_marl_tpu_torch.rl.pipeline import (
        make_pipelined_runner,
        split_half,
    )
    from vit_marl_tpu_torch.rl.ppo import pipeline_generators

    E = args.envs
    if args.policy == "none":
        raise ValueError("pipeline mode needs a policy in the loop")
    if E % 2:
        raise ValueError("pipeline mode needs an even env count")
    env, params, _, obs, state, nets, hs = _bench_setup(args, dev)
    half = E // 2

    def policy_half(_, pol_state, obs_h):
        gen, hs_h = pol_state
        acts = _policy_actions(nets, hs_h, obs_h, half, gen)
        return (gen, hs_h), acts, acts

    def env_half(_, env_carry, acts):
        gen, st = env_carry
        obs_h, st, rew, _, _ = env.step_vec(st, acts, params, generator=gen)
        return (gen, st), obs_h, rew[0].sum()

    run = make_pipelined_runner(policy_half, env_half,
                                merged=args.mode == "pipeline")
    gens = pipeline_generators(0, dev)
    pol_states = [(gens[0][h], [split_half(c, h, half) for c in hs])
                  for h in (0, 1)]
    env_states = [(gens[1][h], split_half(state, h, half)) for h in (0, 1)]
    pol_ins = [[split_half(o, h, half) for o in obs] for h in (0, 1)]
    with torch.no_grad():
        t0 = time.perf_counter()
        pol_states, env_states, pol_ins, _, eouts = run(
            None, pol_states, env_states, pol_ins, args.steps)
        _sync(dev)
        float(eouts[0][-1] + eouts[1][-1])
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            pol_states, env_states, pol_ins, pouts, eouts = run(
                None, pol_states, env_states, pol_ins, args.steps)
        _sync(dev)
        float(eouts[0][-1] + eouts[1][-1])
        dt = time.perf_counter() - t0
    return dict(value=E * args.steps * args.reps / dt, compile=compile_time,
                run=dt, final=(pol_ins, pouts),
                detail=f"envs={E} steps={args.steps} reps={args.reps} "
                f"msgs/step={env.num_msgs_per_step} halves of {half}")


def bench_scan(args, dev) -> dict:
    """Env-steps/s of the trainer's rollout as a CUDA graph of the step
    (``rl/scan.py``; ``bench.py:398-407``): policy forward, sample and
    env step with the trainer's done handling, written into the
    trajectory buffers.  The first run of ``steps`` steps (warm-up,
    capture, instantiation and its replays) is ``compile``, as the JAX
    bench's first call of its jitted scan is; then ``reps`` timed runs.
    ``capture`` and ``instantiate`` hold their own seconds."""
    from vit_marl_tpu_torch.rl.ppo import Carry
    from vit_marl_tpu_torch.rl.scan import ScanRollout

    E = args.envs
    if args.policy == "none":
        raise ValueError("scan mode needs a policy in the loop")
    env, params, gen, obs, state, nets, hs = _bench_setup(args, dev)
    dones = [torch.zeros(n * E, dtype=torch.bool, device=dev)
             for n in env.n_per_type]
    carry = Carry(state, obs, dones, hs)
    scan = ScanRollout(env.step_vec, nets, params, args.steps, E,
                       env.n_per_type, gen, gen, False, dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        trajs, _, carry = scan.run(carry)
        _sync(dev)
        float(trajs[0].reward.sum())
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            trajs, _, carry = scan.run(carry)
        _sync(dev)
        float(trajs[0].reward.sum())
        dt = time.perf_counter() - t0
    return dict(value=E * args.steps * args.reps / dt, compile=compile_time,
                run=dt, capture=scan.capture_s,
                instantiate=scan.instantiate_s,
                detail=f"envs={E} steps={args.steps} reps={args.reps} "
                f"msgs/step={env.num_msgs_per_step} capture="
                f"{scan.capture_s:.3f}s instantiate="
                f"{scan.instantiate_s:.3f}s")


def bench_vit_images(args, dev) -> dict:
    """ViT fwd+bwd images/s inside a PPO update (``bench.py:630-700``): one
    minibatch step of the ViT actor-critic (clipped surrogate, value and
    entropy terms, backward, Adam) on T=16 x B random book images."""
    from vit_marl_tpu_torch.models.rnn import ScannedGRU
    from vit_marl_tpu_torch.models.vit import ViTActorCriticRNN

    T, B = 16, max(args.envs // 16, 16)
    torch.manual_seed(0)
    net = ViTActorCriticRNN(
        obs_dim=28, levels=10, action_dim=3,
        vit=_vit_config(args, PRESETS[args.policy]), fc_dim=64,
        hidden_size=64, action_low=torch.tensor([-1.0, 0.0, 0.0]),
        action_high=torch.tensor([3.0, 1.0, 1.0])).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    obs = {"obs": torch.randn((T, B, 28), generator=gen, device=dev),
           "vision_obs": torch.randn((T, B, 10, 3, 2), generator=gen,
                                     device=dev)}
    dones = torch.zeros((T, B), dtype=torch.bool, device=dev)
    h = ScannedGRU.initialize_carry(B, 64, dev)
    opt = torch.optim.Adam(net.parameters(), lr=2.5e-4)
    action = torch.zeros((T, B, 3), device=dev)
    old_logp = torch.zeros((T, B), device=dev)
    gae = torch.ones((T, B), device=dev)

    def ppo_step():
        opt.zero_grad(set_to_none=True)
        _, pi, value = net(h, obs, dones)
        ratio = torch.exp(pi.log_prob(action) - old_logp)
        a_loss = -torch.minimum(ratio * gae,
                                ratio.clamp(0.8, 1.2) * gae).mean()
        loss = (a_loss + 0.5 * value.square().mean()
                - 0.01 * pi.entropy().mean())
        loss.backward()
        opt.step()
        return loss.detach()

    t0 = time.perf_counter()
    float(ppo_step())
    compile_time = time.perf_counter() - t0
    iters = max(args.reps * 4, 8)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = ppo_step()
    _sync(dev)
    float(loss)
    dt = time.perf_counter() - t0
    return dict(value=T * B * iters / dt, compile=compile_time, run=dt,
                detail=f"T={T} B={B} iters={iters}")


def selfcheck(args, dev) -> dict:
    """Every kernel against its plain version (``vit_marl_tpu_torch/
    selfcheck.py``); the line's value is true or false, ``kernels`` the
    max abs error of each."""
    from vit_marl_tpu_torch.selfcheck import kernel_selfcheck

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    env = bench_world(argparse.Namespace(**{**vars(args),
                                            "policy": "gru"}), dev)
    t0 = time.perf_counter()
    res = kernel_selfcheck(env, args.envs, gen)
    dt = time.perf_counter() - t0
    errs = {k: r[1] for k, r in res.items()}
    return dict(value=all(r[0] for r in res.values()), compile=0.0, run=dt,
                detail=f"envs={args.envs} max abs errors {errs}",
                kernels=errs)


def measure(args, dev) -> dict:
    """The measurement ``args`` name, on ``dev``: a dict with ``value``,
    ``compile``, ``run`` and ``detail`` (and what the measurement adds)."""
    if args.vit_images:
        return bench_vit_images(args, dev)
    if args.selfcheck:
        return selfcheck(args, dev)
    if args.mode.startswith("pipeline"):
        return bench_pipeline(args, dev)
    if args.mode == "scan":
        return bench_scan(args, dev)
    return bench_loop(args, dev)


def main(argv=None):
    """Run the bench; returns the printed result dict.  After printing
    the error line, raises ``SystemExit`` (non-zero) when there is no
    card, when the selfcheck or ``--mode scan`` is asked of the CPU, or
    when the selfcheck fails."""
    args = parse_args(argv)
    metric, unit = metric_label(args)
    from vit_marl_tpu_torch.utils.device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(_error_json(metric, f"no_device: {e}", unit), flush=True)
        raise SystemExit(1)
    if args.selfcheck and dev.type != "cuda":
        print(_error_json(metric, "the selfcheck needs a CUDA device", unit),
              flush=True)
        raise SystemExit(1)
    if args.mode == "scan" and not args.vit_images and not args.selfcheck \
            and dev.type != "cuda":
        print(_error_json(metric, "--mode scan replays a CUDA graph: it "
                                  "needs a CUDA device", unit), flush=True)
        raise SystemExit(1)
    watchdog = arm_deadline(metric, args.deadline, unit)
    try:
        out = measure(args, dev)
    finally:
        watchdog.cancel()
    value = out["value"]
    result = {"metric": metric,
              "value": value if args.selfcheck else round(value, 1),
              "unit": unit, "vs_baseline": None}
    if "kernels" in out:
        result["kernels"] = out["kernels"]
    print(json.dumps(result), flush=True)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# device={dev.type} ({name}) {out['detail']} "
          f"compile={out['compile']:.1f}s run={out['run']:.2f}s",
          file=sys.stderr, flush=True)
    if args.selfcheck and not value:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
