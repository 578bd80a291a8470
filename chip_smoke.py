#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure exits non-zero):

1. device: the card's name and power limit, and the nvcc builds of the
   kernels in ``vit_marl_tpu_torch/ops/csrc/`` (one nvcc per source, all
   started together); the book scan's launch plans, and the tile plan,
   registers, spill bytes and clusters a wave of the four bf16
   tensor-core fused-block kernels at ViT-Small's shapes;
2. book scan against plain: the CUDA book scan in aggregate mode (kernel
   1) against its plain PyTorch version at the 2-player path's shape
   (E=4096 envs, M=112 messages, S=128 slots, 2 traders) on seeded random
   books and streams in all four cancel modes, on corner books and
   streams (``tests/torch_cases.py::make_corner_case``: live quantities of
   0 and below, stale planes in holes, shared INIT_ID and zero order ids,
   crossing quantities whose prefix sums wrap int32, every (type, side))
   in all four cancel modes, on a stream built by the port's own message
   builder, and at E=1000; every output must be bit-equal.  All of it goes
   through the wrapper the environment calls.  Prints the kernel's launch
   plan (registers a thread, resident warps an SM, waves at each E) and
   times it (CUDA events around back-to-back launches, so the card never
   waits on the host; median over batches) at E=4096, 1024 (the vision
   path) and 512 (the vision simplest-case path), at E=4096 with a cold L2
   (launches rotate over three input sets, 120 MB of inputs), and the
   plain version, beside the least time the card could take (bytes moved
   over 3.35 TB/s);
3. records scan against plain: the book scan in records mode (kernel 2,
   the ``debug_mode`` trade log) against its plain version, bit-equal, at
   E=4096, M=112, S=128 in all four cancel modes at rec_k 16 and 128, on
   streams where some messages sweep a whole side (more than 16 fills),
   on corner streams with sweeps in all four modes, and at a ragged
   E=1000; the trade logs built from the two versions' records must be
   equal.  Times the kernel at rec_k 16 and 128, its plain version and its
   bound, as phase 2 does;
4. attention against plain: the CUDA short-attention forward and backward
   through the autograd wrapper the ViT calls, against the plain versions
   on the card, at the vision path's shapes (ViT-Small: N=11 tokens,
   W=384, H=6, bf16; B=1024 images in the rollout, 32,768 in a PPO
   minibatch), at a ragged B=1000 in bf16 and float32, at H=2, D=32, and
   at every padding of the bf16 route (N in 1, 11, 16, 17, 32; D in 8,
   24, 64, 128; B down to 3) on both routes (bf16: tensor cores, float32:
   CUDA cores; each launch must go to its dtype's route).  float32 within
   rtol 1e-5 / atol 1e-6, bf16 within one bf16 ulp (rtol 8e-3, atol
   1e-3); the float32 backward also against autograd of the plain
   forward.  Times both kernels (the forward at B=32,768 and 1,024) beside
   their times before the redesign, their device times alone (replays of
   a CUDA graph of launches, no host issue in the window) and the host's
   issue time per call at B=1,024, the plain versions and
   ``torch.nn.functional.scaled_dot_product_attention`` (forward at both
   batches, and backward through autograd) on inputs laid out for it
   beforehand, the yardstick of one library call, which the port never
   makes;
5. fused blocks against plain: the four CUDA fused-block kernels (LN+QKV,
   proj+MLP, the whole block, LN+QKV+attention) through the wrappers the
   ViT calls, against their plain versions on the card at ViT-Small's
   shapes (N=11, W=384, H=6, hidden 1,536) at B=1,024, 32,768, a ragged
   1,000 and a ragged 5,003 images (more tiles than one persistent wave,
   a last tile part full) in bf16 (within two bf16 ulps of the element,
   rtol 1.6e-2, or two or three of the output's largest magnitude, see
   ``block_tol``) and at B=1,024 and 1,000 in float32 (rtol 2e-5, atol
   2e-5); every bf16 launch must take the tensor-core route (``wgmma``),
   every float32 one the CUDA-core route (``simt``), counted exactly.
   Times each kernel at B=32,768 and 1,024 (bf16) through the wrapper and
   on the card alone (replays of a CUDA graph), beside its time in the
   parent tree (its chip_smoke.py run, printed from ``PARENT_MS``), its plain
   version and the port's unfused PyTorch sequence for the same function
   (``F.layer_norm`` + ``F.linear`` + ``F.gelu`` +
   ``scaled_dot_product_attention``), the yardstick; no single PyTorch
   call computes these functions;
6. 2-player training: ``make_train`` on ``configs/ippo_2player.yaml`` at
   its published widths and NUM_ENVS=4096 on the card for 2 updates;
   losses must be finite, the env-info metrics (``LOG_ENV_INFO``, on by
   default) present, and the book scan's launch count must rise by
   exactly the rollout steps the wrapper launches (``rollout_steps``:
   NUM_STEPS x updates under the loop, the warm-up step under the
   scan); then 2 updates with ``LOG_ENV_INFO``
   off, and the rollout seconds of both; the card kernels of one step's
   info reduction (``torch.profiler``);
7. debug-mode training: the same config with ``WORLD.DEBUG_MODE=true``
   (set through the port's ``--set`` parser) for 2 updates; losses must be
   finite, the records scan must launch exactly once a rollout step of
   ``rollout_steps`` (rec_k 16) and the aggregate scan never, and the
   last step's trade log
   must hold trades.  Then phase 6's training runs once more, so the
   debug path's rate stands between two warm aggregate runs;
8. vision training: ``make_train`` on ``configs/ippo_vision_dual_ppo.yaml``
   at its published widths (ViT-Small, NUM_ENVS=1024, NUM_STEPS=128) for
   2 updates; losses must be finite, the book scan must launch once a
   rollout step of ``rollout_steps`` and the attention kernels exactly
   as often as the ViT's blocks run through the wrappers (with remat the
   forward runs twice per block in an update),
   every launch on the bf16 tensor-core route;
9. vision simplest-case training: the same for
   ``configs/ippo_vision_simplest.yaml`` (ViT-Small, 512 envs x 32 steps,
   the discrete ``simplest_case`` execution agent alone);
10. fused-mode vision training: phase 8, 1 update in each of the three
   fused-block modes (``VIT_ATTN_LN_FOLD``, ``VIT_FUSED_BLOCK``,
   ``VIT_FUSED_BLOCK_FULL``) with one PPO epoch (the config has 4: the
   cut that makes room for phase 18), with the exact launch count of
   every kernel,
   every launch of the four fused-block kernels on the bf16 tensor-core
   route;
11. bench: ``vit_marl_tpu_torch/bench.py`` in-process, the loop with GRU
   and ViT-Small policies (4,096 envs, 10 steps, 2 reps), ``--vit-images``
   and ``--selfcheck`` (every kernel against its plain version at the
   bench's shapes); each JSON line must parse with a value > 0 (true),
   each loop's launches must be exact;
12. checkpoint and resume: ``configs/ippo_vision_simplest.yaml``, 2
   updates with ``CHECKPOINT_DIR``, then ``RESUME=true`` for one more: the
   restored tensors equal the saved ones, the update index continues, the
   losses are finite and the launches exact;
13. LOBSTER: ``configs/ippo_2player.yaml`` at 1,024 envs fed by CSVs
   written from a synthetic day, one update, the book scan's launches
   exact;
14. the fused modes at ViT-Base's width (W=768, hidden 3,072): one bf16
   block of each mode forward and backward at B=1,024 images, against
   the plain versions at ``block_tol``, every call on the ``composed``
   route and none on a kernel, counted exactly; their times;
15. entry: ``vit_marl_tpu_torch/graft_entry.py::entry`` on the card,
   against the same weights on the CPU;
16. agent spaces: one update of ``configs/sweep_fine.yaml``'s
   base run (its ``SWEEP:`` dropped; 512 envs x 128 steps, MM ``basic``,
   execution ``fixed_quants`` + ``basic``); worlds of
   every newly ported agent space and a ``fixed_time`` world (``SPACE_
   WORLDS``), 4 steps each at 4,096 envs, then one step of the same state
   and draws at E=256 through the kernel and through the plain book scan
   on the card (books, best quotes and integer state bit-equal, rewards
   and observations within 1e-5); kernel 1 timed at M=126 beside its
   bound, kernel 2 checked at M=126 in ``debug_mode``; the launch
   count of every run exact (the evaluation moved to phase 19);
17. networks, layouts, pipeline and data parallelism (the port's
   eleventh slice), each path one update (one PPO epoch, the cut that
   makes room for phases 19-20) with every count set to 0 just
   before it and its launches exact: ``configs/ippo_vision_dual_ppo.yaml``
   on ``NETWORK=[gru, cnn_gru]`` (1,024 envs); ``ippo_2player.yaml`` with
   a ``fixed_prices`` execution agent (a ``Box`` on ``gru``, 512 envs x
   128 steps); the ViT-Small encoder forward and backward at B=1,024
   images on the same weights as flat rows (the kernels), flat rows with
   the XLA-form attention and ``(B, N, W)`` tokens (bf16: the rank-3
   embeddings within ``block_tol`` of the flat XLA-form ones, one block
   of each layout on its own attention route within ``block_tol``; the
   ``(B, N, W)`` layout launches no attention kernel); ``ippo_vision_simplest.yaml`` with ``VISION_LEVELS=40`` (41
   tokens: every attention on ``dot_product_attention``, counted, none on
   kernels 3-4); ``ROLLOUT_MODE=pipeline`` on the vision config (1,024
   envs, the book scan once a half-batch step); the bench at 4,096 envs
   with ViT-Small in ``loop``, ``pipeline-seq`` and ``pipeline`` modes
   (the two-stream pipeline bit-equal to the one-stream schedule in
   observations and actions; the three rates);
   ``configs/mesh_ippo_2player.yaml`` as one rank of its 8-way run (a
   1-rank NCCL group, 4,096 envs, 10 + 10 agents, M=220): one update,
   finite losses, kernel 1's launches exact; kernel 1 at E=4,096, M=220,
   20 traders bit-equal to its plain version in all four cancel modes and
   on the world's stream, its launch plan, time, bound and plain time;
18. kernels 5 and 7 past 32 tokens and the rollout as a CUDA graph (the
   port's twelfth slice), each path driven with every count set to 0
   just before it: ``fused_block_full`` and ``fused_ln_qkv_attn`` at
   ViT-Small's widths against their plain versions at N in 33, 41, 51,
   64, 65, 128, 129 and 257 on 64 images in bf16 and float32 within
   ``block_tol`` (their route past 32 tokens: LN+QKV's kernel into a
   qkv buffer, ``csrc/long_attention.cuh``, and for the full block
   proj+MLP's kernel; each call counted once on its dtype's route), and
   at N=41 on 1,024 and 8,192 images again within ``block_tol`` and
   timed beside their bounds, plain versions and the unfused sequence;
   one update (one PPO epoch) of ``ippo_vision_simplest.yaml`` at
   ``VISION_LEVELS=40`` under ``VIT_FUSED_BLOCK_FULL`` and under
   ``VIT_ATTN_LN_FOLD`` (every
   forward on the kernel, bf16 route; no attention backward kernel past
   32 tokens), then its rollout alone under ``torch.profiler`` in both
   modes; ``ROLLOUT_MODE=scan`` against ``loop`` on ``ippo_2player.yaml``
   (4,096 envs, also with ``DEBUG_MODE``), ``ippo_vision_dual_ppo.yaml``
   (1,024 envs) and its ``cnn_gru`` network (with cuDNN's deterministic
   algorithms): update 0 under each, its metrics bit-equal, the wrappers'
   launches exact, its peak memory; then the rollout alone (in turns:
   loop, scan, scan, loop, for the 2-player and vision configs) after
   the scan's set-up (warm-up, capture and instantiation
   timed apart); the graph's hand-written kernel nodes (its DOT dump)
   equal to a loop step's launches, the graph replayed NUM_STEPS times
   in each run of the scan (counted where it replays); the first
   ``TRACE_STEPS`` (16) steps of each mode under ``torch.profiler`` (the
   scan's on the same graph): the card's busy share of the kernel window,
   the loop's wrappers exact, the scan's graph replayed once a step and
   no wrapper, each trace holding the hand-written kernels' launches
   (counted by name) that its run made, within ``TRACE_LOSS`` (or 2
   records a 128 steps traced);
   the bench at 4,096 envs, ``--mode loop`` and ``--mode scan`` with GRU
   and ViT-Small policies, each line printed.  Update 0 of each config
   takes one PPO epoch, and the rollout's turns are loop, scan, scan,
   loop (the cuts that make room for phases 19-20);
19. greedy eval and ``evaluate.py`` as CUDA graphs (the port's
   fourteenth slice): one update (one PPO epoch) of
   ``ippo_2player.yaml`` at 4,096 envs and of
   ``ippo_vision_dual_ppo.yaml`` at 1,024 envs with ``EVAL_EVERY=1``,
   ``EVAL_STEPS=32`` (the eval on its graph, launches exact, the eval
   keys finite; the 2-player run checkpointed); then each eval alone,
   ``rl/ppo.py::EvalRollout`` against ``eval_rollout_loop`` in turns
   (loop, graph, graph, loop), each pair from one generator
   state and bit-equal in every metric, with seconds and env-steps/s
   beside the earlier host-issued rate; ``evaluate.py`` at 4,096 envs x 50
   steps on the 2-player checkpoint (graphs), then on the
   ``AvSt``/``twap`` baseline world under ``ROLLOUT_MODE`` loop and scan
   (the summaries of the modes equal), each label's seconds;
20. the ``model`` mesh axis: one update of ``ippo_vision_dual_ppo.yaml``
   at ViT-Small width, cut to 256 envs x 32 steps, 2 minibatches and one
   epoch, in one process, then on a ``(1, 2)`` data x model mesh as two
   processes on the card in a gloo group (NCCL puts no two ranks on one
   card): each rank's launches exact, the ranks' weights identical,
   their metrics within rtol 5e-4 / atol 1e-5 and their weights within 3
   x the learning rate of one process's; each rank's bytes of stored
   parameters and Adam state against one process's;
21. the order-book engine and the tools (the port's fifteenth slice):
   the ``OrderBook`` facade and ``lob/engine.py``'s scans at E=256,
   M=112, S=128 in each cancel mode on corner streams, every output
   (books, logs, best quotes, saved states, queries) bit-equal on the
   card and the CPU; on the corners both JAX engines share, the engine
   against kernel 2 at ``rec_k = S`` and the log built from its records;
   the engine's ms a message and kernel 2's ms a step at E=4,096; then,
   each driven with every count set to 0 just before it,
   ``eval/speed_test.py::run_speed_grid`` ((1, 1) and (10, 10) agents,
   100 data messages, 4,096 envs x 20 steps; kernel 1 once a step),
   ``rl/sweep.py::run_sweep`` over two combinations of
   ``sweep_fine.yaml``'s grid at one update each, and one update (one
   PPO epoch) of ``ippo_vision_dual_ppo.yaml`` under
   ``utils/profiling.py::trace`` with its drain, its ten largest CUDA ops
   by self time;
22. the book scan at every capacity (the port's sixteenth slice):
   kernels 1 and 2 against their plain versions, bit-equal, at S in
   ``CAPACITIES`` (2, 24, 100, 200, 384, 1,024: the masked route) and
   E=1,024 in cancel modes 0 (random streams) and 3 (corner streams),
   both with sweeps, on full bid books below -1 at S=24 and 100, and at
   S=32, 64 and 256 (the exact route); each route's launch plan; both
   kernels timed at E=4,096 at S=128 and 100 in turns, the masked route
   at S=128 on the same data, and S=1,024, beside their plain versions
   (every output bit-equal to the kernels' on the same inputs) and
   bounds; both at S=100, E=4,096 in cancel mode 3, records at rec_k 100
   (the ``debug_mode`` path), bit-equal to their plain versions; one
   update (one epoch) of ``ippo_2player.yaml`` at 100 orders a side,
   4,096 envs x 128 steps on the graph, and the same in
   ``debug_mode`` with cancel mode 3, kernel launches counted through the
   wrapper and on the graph; ``WorldEnv.reset_env`` and 8 ``step``s with
   sampled actions on the card and on the CPU, equal; and
   ``tools/torch_fuzz_engine.py --kernel --minutes 0.5``;
23. the book scan past 1,024 slots and the port's kernel A/B and ViT
   stage tools (the port's seventeenth slice): each route's launch plan
   at S of 1,025 to 16,384; kernels 1 and 2 on the block route against
   their plain versions, bit-equal, at S in ``DEEP_CAPACITIES`` (1,025,
   1,500, 2,048, 4,096) and E=256 in cancel modes 0 (random streams,
   records at rec_k 16) and 3 (corner streams, rec_k = S), both with
   sweeps, on full bid books below -1 at S=1,500 and 2,048, and at
   S=16,384 (the book in device memory) and E=32 in modes 0 and 3; both
   timed at E=4,096, M=112, cancel mode 1 at S=2,048 and 4,096 beside
   their plain versions (every output bit-equal) and bounds, and kernel
   1's block route against its warp route at S=512 and 1,024 in turns on
   the same data (bit-equal); one update (one epoch) of
   ``ippo_2player.yaml`` at 2,048 orders a side, 4,096 envs x 128 steps
   on the graph, and in ``debug_mode`` with cancel mode 3 at 512 envs
   (records at rec_k 2,048), launches counted through the wrapper and on
   the graph; ``tools/torch_kernel_bench.py`` and
   ``tools/torch_profile_vit.py`` at 8,192 envs, ``--reps 3``, their
   tables printed.
Every training phase (6-20, 22-23) collects with ``ROLLOUT_MODE``'s
default, ``auto``: on the card a CUDA graph of the env step (``rl/scan.py``),
replayed each step.  A wrapper counts the launches it makes: under the
scan the warm-up step's (``rollout_steps``) and the update's; the
graph's replays launch without the wrappers; phase 18 reads the
graph's kernel nodes, counts its replays where they are made
(``StepGraph.replays``) and holds profiler traces against them.
Then one JSON line describing the eight kernels, and the last line
``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import tempfile
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import yaml

from vit_marl_tpu_torch.selfcheck import (
    ATT_TOL,
    F32_BLOCK_TOL,
    block_calls,
    block_params,
    block_tol,
    unfused_call,
)
from vit_marl_tpu_torch.utils.roofline import (
    F32_FLOPS,
    HBM_BYTES_PER_S,
    attention_cost,
    block_bound,
    block_cost,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "ippo_2player.yaml")
VISION_CONFIG = os.path.join(ROOT, "configs", "ippo_vision_dual_ppo.yaml")
SWEEP_CONFIG = os.path.join(ROOT, "configs", "sweep_fine.yaml")
SIMPLEST_CONFIG = os.path.join(ROOT, "configs", "ippo_vision_simplest.yaml")
REC_KS = (16, 128)              # records per message: debug log, every slot
E_MAIN, M_MAIN, S_MAIN = 4096, 112, 128
# the book scan's batch on each path: (path, launches an update)
SCAN_LAUNCHES = {4096: ("2-player", 128), 1024: ("vision", 128),
                 512: ("vision simplest", 32)}
AGENT_TIDS = (-100, -101)
TICK = 100
UPDATES = 2
SEED = 30
BATCHES, PER_BATCH = 10, 20     # kernel timing: batches of launches
# ViT-Small attention: tokens, width, heads; images per rollout step and
# per PPO minibatch (128 steps x 1024 envs / 4 minibatches)
ATT_N, ATT_W, ATT_H = 11, 384, 6
B_ROLLOUT, B_MINIBATCH = 1024, 32_768
# (B, N, H, D) the bf16 route pads: N to 16 or 32 tokens, D to a multiple
# of 16; ragged B and a B below the persistent grid (3 images)
ATT_PAD_SHAPES = [((1000, 3, 37, 130)[i % 4], n, (1, 2, 3)[i % 3], d)
                  for i, (n, d) in enumerate(
                      (n, d) for n in (1, 11, 16, 17, 32)
                      for d in (8, 24, 64, 128))]
# the attention kernels' times before their redesign (chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700 W): forward at B=32,768 and 1,024, backward
ATT_EARLIER_MS = {"fwd": 1.1845, "fwd_rollout": 0.0472, "bwd": 2.9990}
MLP_RATIO = 4
# ViT-Base: width, heads; images of the W=768 phase
BASE_W, BASE_H, B_BASE = 768, 12, 1024
# the bench phase's arguments (in-process ``bench.main``)
BENCH_ARGS = ["--envs", "4096", "--steps", "10", "--reps", "2",
              "--deadline", "600"]


# phase 16's worlds: (agent kind, overrides) per type, instances per type,
# world fields.  Every agent space the 2-player path does not run, and
# fixed_time episodes; "m126" carries 100 + 16 + 8 + 2 = 126 messages a
# step, where kernel 1 is timed (and kernel 2 checked in debug_mode); a
# fixed_time episode of 30 s is shorter than a step of 100 data messages
# (about 47 s of the synthetic day), so every step's stream holds data
# rows past the episode's end.
SPACE_WORLDS = {
    "mm": ([("mm", dict(action_space="fixed_quants",
                        sell_buy_all_option=True, reward_space="complex",
                        inv_penalty="linear",
                        reference_price_portfolio_value="best_bid_ask",
                        observation_space="basic")),
            ("mm", dict(action_space="simple", reward_space="spooner_damped",
                        inv_penalty="quadratic", clip_reward=True,
                        reference_price_portfolio_value="near_touch")),
            ("mm", dict(action_space="AvSt", reward_space="delta_netWorth",
                        inv_penalty="threshold",
                        exclude_extreme_spreads=True,
                        observation_space="messages")),
            ("mm", dict(action_space="directional_trading",
                        reward_space="weight_pnl_inventory_pnl",
                        based_on_mid_price_of_action=False,
                        observation_space="messages_tokenized")),
            ("mm", dict(multiplier_type="spread",
                        reward_space="spooner_scaled")),
            ("exe", dict(action_space="fixed_quants", observation_space="basic",
                         reward_space="finish_fast"))], (1, 1, 1, 1, 1, 1), {}),
    "exe": ([("mm", dict(reward_space="portfolio_value_scaled",
                         inv_penalty="linear")),
             ("mm", dict(action_space="simple", sell_buy_all_option=True,
                         fixed_action_setting=True, fixed_action=1,
                         reward_space="zero_inv")),
             ("exe", dict(action_space="fixed_prices", n_actions=2,
                          action_type="delta", task_size=40)),
             ("exe", dict(action_space="twap", reward_space="finish_fast")),
             ("exe", dict(action_space="twap_v3", task_size=45,
                          reward_space="simplest_case"))], (1, 1, 2, 1, 2),
            {}),
    "m126": ([("mm", dict(action_space="fixed_prices", n_actions=8,
                          reward_space="pnl")),
              ("exe", dict(action_space="fixed_prices", n_actions=4,
                           task_size=60)),
              ("exe", dict(action_space="fixed_quants_1msg",
                           reward_space="normal"))], (1, 1, 1), {}),
    "fixed_time": ([("mm", dict()), ("mm", dict(action_space="AvSt")),
                    ("exe", dict()),
                    ("exe", dict(action_space="twap_v3",
                                 observation_space="basic", task_size=80))],
                   (1, 1, 2, 1), dict(ep_type="fixed_time", episode_time=30,
                                      start_resolution=30)),
}
M_SPACES = 126
E_CHECK = 256
DEV = "cuda"                    # where phase 16 builds its worlds
SPACE_STEPS = 4
EVAL_STEPS, EVAL_LABEL_STEPS = 32, 50
# phase 17: the book image of the long-attention update (41 tokens), the
# mesh config's rank (its 32,768 envs over its 8 ranks) and messages a step
# (100 data + 10 market makers x 4 + 10 execution agents x 8)
LONG_LEVELS = 40
MESH_CONFIG = os.path.join(ROOT, "configs", "mesh_ippo_2player.yaml")
MESH_ENVS, M_MESH = 4096, 220
BOX_ENVS = 512


# the fused-block kernels: wrapper name -> (TPU function, ViT mode whose
# training launches it)
BLOCK_KERNELS = {
    "fused_ln_qkv": ("vit_marl_tpu/ops/block_kernel.py:88", "fused_block"),
    "fused_proj_mlp": ("vit_marl_tpu/ops/block_kernel.py:169",
                       "fused_block"),
    "fused_block_full": ("vit_marl_tpu/ops/block_kernel.py:286",
                         "fused_block_full"),
    "fused_ln_qkv_attn": ("vit_marl_tpu/ops/block_kernel.py:408",
                          "attn_ln_fold"),
}
# the fused-block kernels with a bf16 tensor-core route: all four
TC_KERNELS = tuple(BLOCK_KERNELS)
# their times in the parent tree (its chip_smoke.py run, NVIDIA H100
# 80GB HBM3, 700 W), ms through the wrapper at B=32,768 and 1,024,
# printed beside this run's
PARENT_MS = {"fused_ln_qkv": (3.4833, 0.1542),
             "fused_proj_mlp": (4.4931, 0.2365),
             "fused_block_full": (10.4012, 0.4300),
             "fused_ln_qkv_attn": (5.2402, 0.2074)}


def phase(name, t0):
    print(f"phase {name}: ok ({time.perf_counter() - t0:.2f}s)", flush=True)


def scan_bytes(E, M, S, n_agg):
    """Bytes the scan must move in a deterministic cancel mode: messages,
    book, previous prices and trader ids read once; book, best prices and
    sums written once (int32)."""
    ins = E * M * 8 + E * 2 * 6 * S + E * 2 + n_agg
    outs = E * 2 * 6 * S + E * M * 4 + E * (8 * n_agg + 2)
    return 4 * (ins + outs)


def records_bytes(E, M, S, rec_k, mode):
    """Bytes the records scan must move: messages, book, previous prices
    (and the uniforms in the random-cancel modes) read once; book, best
    prices, records and fill counts written once (int32)."""
    ins = E * M * 8 + E * 2 * 6 * S + E * 2 + (M * E if mode >= 2 else 0)
    outs = E * 2 * 6 * S + E * M * 4 + E * M * rec_k * 4 + E * M
    return 4 * (ins + outs)


def records_phase(torch, bkern, smi, case, main_mode):
    """Check the records scan against its plain version, and the trade logs
    built from their records, at the main path's shape in every cancel
    mode (random and corner streams) and at a ragged E; time it.
    ``case(E, seed, corners=False)`` gives (msgs, book, prev, uniforms) on
    the card.  Returns the kernel's summary entry
    (without launches)."""
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import init_trades
    max_err = 0
    cases = {}

    def compare(cfg, msgs, book, prev, u, rec_k, label):
        nonlocal max_err
        got = bkern.process_step_records(cfg, msgs, book, prev, rec_k, u)
        want = bkern.process_step_records_reference(cfg, msgs, book, prev,
                                                    rec_k, u)
        E = msgs.shape[0]
        logs = [bkern.finalize_trade_log_from_records(
            init_trades(cfg, E, msgs.device), r[2][0], msgs, r[2][1])
            for r in (got, want)]
        torch.cuda.synchronize()
        pairs = [(got[0].data, want[0].data), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1]), (got[2][0], want[2][0]),
                 (got[2][1], want[2][1]), tuple(logs)]
        err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"records kernel != plain on {label}: "
                                 f"max abs err {err}")
        counts = want[2][1]
        if int(counts.max()) <= 16:
            raise AssertionError(f"{label}: no message filled more than 16 "
                                 "orders")
        n_logged = int((logs[0][:, :, 0] != -1).sum())
        print(f"  {label}, rec_k={rec_k}: bit-equal, trade logs equal "
              f"(E={E}, {int(counts.sum())} fills, most in one message "
              f"{int(counts.max())}, {int((counts > rec_k).sum())} messages "
              f"over rec_k, {n_logged} log rows)", flush=True)

    for mode in range(4):
        cfg = EngineConfig(n_orders=S_MAIN, cancel_mode=mode)
        cases[mode] = case(E_MAIN, SEED + 10 + mode)
        corners = case(E_MAIN, SEED + 20 + mode, corners=True)
        for rec_k in REC_KS:
            compare(cfg, *cases[mode], rec_k,
                    f"streams with sweeps, cancel mode {mode}")
            compare(cfg, *corners, rec_k,
                    f"corner streams with sweeps, cancel mode {mode}")
        del corners
    cfg = EngineConfig(n_orders=S_MAIN, cancel_mode=main_mode)
    ragged = case(1000, SEED + 14)
    for rec_k in REC_KS:
        compare(cfg, *ragged, rec_k, "streams with sweeps, E=1000")

    msgs, book, prev, u = cases[main_mode]
    sms = torch.cuda.get_device_properties(msgs.device).multi_processor_count
    plans = {}
    for rec_k in REC_KS:
        plan = plans[rec_k] = bkern.launch_plan(S_MAIN, None, msgs.device,
                                                rec_k)
        print(f"  launch plan, rec_k={rec_k}: {plan['registers']} registers "
              f"a thread, {plan['spill_bytes']} spill bytes, "
              f"{plan['warps_per_sm']} warps an SM: "
              f"{-(-E_MAIN // (plan['warps_per_sm'] * sms))} wave(s) at "
              f"E={E_MAIN}", flush=True)
    rows = {}
    for rec_k in REC_KS:
        ms, ms_min = time_launches(lambda: bkern.process_step_records(
            cfg, msgs, book, prev, rec_k, u))
        plain = []
        for _ in range(3):
            torch.cuda.synchronize()
            tp = time.perf_counter()
            bkern.process_step_records_reference(cfg, msgs, book, prev,
                                                 rec_k, u)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - tp) * 1e3)
        nbytes = records_bytes(E_MAIN, M_MAIN, S_MAIN, rec_k, main_mode)
        rows[rec_k] = dict(ms=ms, plain_ms=float(np.median(plain)),
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(f"  rec_k={rec_k}: kernel {ms:.4f} ms per launch (median of "
              f"{BATCHES} batches of {PER_BATCH}, min {ms_min:.4f}); plain "
              f"{rows[rec_k]['plain_ms']:.2f} ms; bound "
              f"{rows[rec_k]['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
              f"3.35 TB/s) [{smi}]", flush=True)
    main = rows[REC_KS[0]]
    return dict(
        name="book_scan_records", route="cuda",
        source="vit_marl_tpu_torch/ops/csrc/book_scan.cu",
        replaces="vit_marl_tpu/ops/book_kernel.py:479",
        bit_equal=max_err == 0, max_abs_err=max_err, rec_k=REC_KS[0],
        ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
        registers=plans[REC_KS[0]]["registers"],
        warps_per_sm=plans[REC_KS[0]]["warps_per_sm"],
        ms_rec_k_128=rows[128]["ms"], plain_ms_rec_k_128=rows[128]["plain_ms"],
        bound_ms_rec_k_128=rows[128]["bound_ms"],
        registers_rec_k_128=plans[128]["registers"],
        warps_per_sm_rec_k_128=plans[128]["warps_per_sm"])


def time_launches(fn, batches=BATCHES, per_batch=PER_BATCH, warm=5):
    """Median and min ms per call over batches of back-to-back calls,
    timed with CUDA events.  One untimed call keeps the card busy while
    the first event is queued."""
    import torch
    for _ in range(warm):
        fn()
    per = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / per_batch)
    return float(np.median(per)), float(min(per))


def graph_ms(fn, batches=BATCHES, per_batch=PER_BATCH):
    """Median device ms per call over replays of a CUDA graph of
    ``per_batch`` calls: no host issue inside the timed window."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_batch):
            fn()
    per = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / per_batch)
    del graph
    return float(np.median(per))


def host_ms(fn, calls=PER_BATCH):
    """Host ms per call to issue ``calls`` calls back to back."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def bound(nbytes, flops):
    """Least time in ms and what sets it: bytes over the memory rate or
    float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_phase(torch, attn, smi):
    """Check both attention kernels against their plain versions at the
    vision path's shapes and time them; returns the two kernels' summary
    entries (without launches)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    N, W, H = ATT_N, ATT_W, ATT_H
    errs = {"fwd": 0.0, "bwd": 0.0}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(kind, label, got, want, dtype):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got, want, **ATT_TOL[str(dtype)[6:]],
                                   msg=lambda m: f"{label}: {m}")
        errs[kind] = max(errs[kind], err)
        print(f"  {label}: max abs err {err:.3g} "
              f"({str(dtype)[6:]}, tol {ATT_TOL[str(dtype)[6:]]})",
              flush=True)

    for B, h, d, dtype in [(B_ROLLOUT, H, W // H, torch.bfloat16),
                           (B_MINIBATCH, H, W // H, torch.bfloat16),
                           (1000, H, W // H, torch.bfloat16),
                           (1000, H, W // H, torch.float32),
                           (1000, 2, 32, torch.bfloat16)]:
        x = rand((B * N, 3 * h * d), dtype)
        check("fwd", f"forward B={B} H={h} D={d}",
              attn.short_attention(x, N, h),
              attn.short_attention_reference(x, N, h), dtype)
    for B, dtype in [(B_MINIBATCH, torch.bfloat16), (1000, torch.float32)]:
        x = rand((B * N, 3 * W), dtype).requires_grad_(True)
        g = rand((B * N, W), dtype)
        (got,) = torch.autograd.grad(attn.short_attention(x, N, H), x, g)
        check("bwd", f"backward B={B} H={H}", got,
              attn.short_attention_bwd_reference(x.detach(), g, N, H), dtype)
        if dtype == torch.float32:
            (want,) = torch.autograd.grad(
                attn.short_attention_reference(x, N, H), x, g)
            check("bwd", f"backward B={B} against autograd of the plain "
                  "forward", got, want, dtype)
        del x, g, got

    # every padding of the bf16 route, and the same shapes on the float32
    # route; each launch must take its dtype's route
    for dtype, route in [(torch.bfloat16, "mma"), (torch.float32, "simt")]:
        before = route_counts(attn)
        for B, n, h, d in ATT_PAD_SHAPES:
            x = rand((B * n, 3 * h * d), dtype).requires_grad_(True)
            g = rand((B * n, h * d), dtype)
            out = attn.short_attention(x, n, h)
            (got,) = torch.autograd.grad(out, x, g)
            out = out.detach()
            torch.cuda.synchronize()
            for kind, a, b in [
                    ("fwd", out, attn.short_attention_reference(
                        x.detach(), n, h)),
                    ("bwd", got, attn.short_attention_bwd_reference(
                        x.detach(), g, n, h))]:
                err = float((a.float() - b.float()).abs().max())
                torch.testing.assert_close(
                    a, b, **ATT_TOL[str(dtype)[6:]],
                    msg=lambda m: f"{kind} B={B} N={n} H={h} D={d}: {m}")
                errs[kind] = max(errs[kind], err)
        grew = {k: v - before[k] for k, v in route_counts(attn).items()}
        want = {k: 0 for k in grew}
        want[f"fwd_{route}"] = want[f"bwd_{route}"] = len(ATT_PAD_SHAPES)
        if grew != want:
            raise AssertionError(f"{dtype} launches by route {grew}, want "
                                 f"{want}")
        print(f"  {len(ATT_PAD_SHAPES)} padded shapes, forward and "
              f"backward, {str(dtype)[6:]} on the {route} route: within "
              f"{ATT_TOL[str(dtype)[6:]]}", flush=True)

    # timing at the PPO minibatch's shape (and the forward at the
    # rollout's), bf16, as the ViT-Small path launches them
    B, D = B_MINIBATCH, W // H
    x = rand((B * N, 3 * W), torch.bfloat16)
    g = rand((B * N, W), torch.bfloat16)
    q, k, v = x.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).contiguous()
    gl = g.view(B, N, H, D).transpose(1, 2).contiguous()
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl)
    x_roll = x[:B_ROLLOUT * N]
    q_roll, k_roll, v_roll = (t[:B_ROLLOUT] for t in (q, k, v))
    rows = {}
    for kind, kern, plain, lib, backward in [
            ("fwd", lambda: attn.short_attention(x, N, H),
             lambda: attn.short_attention_reference(x, N, H),
             lambda: F.scaled_dot_product_attention(q, k, v), False),
            ("bwd", lambda: attn._launch_bwd(x, g, N, H),
             lambda: attn.short_attention_bwd_reference(x, g, N, H),
             lambda: torch.autograd.grad(lib_out, (ql, kl, vl), gl,
                                         retain_graph=True), True)]:
        ms, ms_min = time_launches(kern)
        plain_ms, _ = time_launches(plain, batches=3, per_batch=3, warm=1)
        lib_ms, _ = time_launches(lib)
        nbytes, flops = attention_cost(B, N, W, H, 2, backward)
        bound_ms, bound_by = bound(nbytes, flops)
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=graph_ms(kern))
        print(f"  {kind} B={B}: kernel {ms:.4f} ms (median of {BATCHES} "
              f"batches of {PER_BATCH}, min {ms_min:.4f}; before the "
              f"redesign {ATT_EARLIER_MS[kind]} ms); device time "
              f"{rows[kind]['device_ms']:.4f} ms (CUDA graph of "
              f"{PER_BATCH}); plain {plain_ms:.3f} ms; SDPA {lib_ms:.4f} "
              f"ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{smi}]",
              flush=True)

    def roll():
        return attn.short_attention(x_roll, N, H)

    roll_ms, roll_min = time_launches(roll)
    roll_dev, roll_host = graph_ms(roll), host_ms(roll)
    roll_lib_ms, _ = time_launches(
        lambda: F.scaled_dot_product_attention(q_roll, k_roll, v_roll))
    roll_bound, _ = bound(*attention_cost(B_ROLLOUT, N, W, H, 2, False))
    print(f"  fwd B={B_ROLLOUT}: kernel {roll_ms:.4f} ms (min "
          f"{roll_min:.4f}; before the redesign "
          f"{ATT_EARLIER_MS['fwd_rollout']} ms); device time "
          f"{roll_dev:.4f} ms (CUDA graph of {PER_BATCH}); host issue "
          f"{roll_host:.4f} ms per call; SDPA {roll_lib_ms:.4f} ms; bound "
          f"{roll_bound:.4f} ms [{smi}]", flush=True)
    common = dict(route="cuda",
                  source="vit_marl_tpu_torch/ops/csrc/short_attention.cu",
                  tolerance=ATT_TOL)
    return {
        "short_attention_fwd": dict(
            name="short_attention_fwd", **common,
            replaces="vit_marl_tpu/ops/attention_kernel.py:253",
            max_abs_err=errs["fwd"], kernel_ms=rows["fwd"]["ms"],
            ms_rollout=roll_ms, bound_ms_rollout=roll_bound,
            library_ms_rollout=roll_lib_ms, device_ms_rollout=roll_dev,
            host_ms_rollout=roll_host, **rows["fwd"]),
        "short_attention_bwd": dict(
            name="short_attention_bwd", **common,
            replaces="vit_marl_tpu/ops/attention_kernel.py:286",
            max_abs_err=errs["bwd"], kernel_ms=rows["bwd"]["ms"],
            **rows["bwd"]),
    }


def fused_calls(torch, blk, name, x, a, p, N, H):
    """(kernel, plain version, unfused PyTorch sequence) of fused-block
    function ``name`` on rows x (and attention rows a for proj+MLP) of
    images of N tokens and H heads, parameters ``p``."""
    return (*block_calls(blk, name, x, a, p, N, H),
            unfused_call(name, x, a, p, N, H))


def block_phase(torch, blk, smi):
    """Check the four fused-block kernels against their plain versions at
    the vision path's shapes and time them beside the unfused PyTorch
    sequence; returns their summary entries (without launches)."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    N, W, H = ATT_N, ATT_W, ATT_H
    hidden = MLP_RATIO * W

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def params(dtype):
        """ViT-Small block parameters: LayerNorms and biases float32,
        weights (out, in) in the compute type."""
        return block_params(gen, dtype, W, hidden)

    def calls(name, x, a, p):
        return fused_calls(torch, blk, name, x, a, p, N, H)

    errs = {name: 0.0 for name in BLOCK_KERNELS}
    p16, p32 = params(torch.bfloat16), params(torch.float32)
    routes0 = block_route_counts(blk)
    for B, dtype in [(B_ROLLOUT, torch.bfloat16), (B_MINIBATCH, torch.bfloat16),
                     (1000, torch.bfloat16), (5003, torch.bfloat16),
                     (B_ROLLOUT, torch.float32), (1000, torch.float32)]:
        dname = str(dtype)[6:]
        p = p16 if dtype == torch.bfloat16 else p32
        x = rand(B * N, W, dtype=dtype)
        a = rand(B * N, W, dtype=dtype)
        for name in BLOCK_KERNELS:
            kern, plain, _ = calls(name, x, a, p)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = block_tol(name, want)
            torch.testing.assert_close(
                got, want, **tol, msg=lambda m: f"{name} B={B} {dname}: {m}")
            errs[name] = max(errs[name], err)
            print(f"  {name} B={B} {dname}: max abs err {err:.3g} (tol "
                  f"{tol})", flush=True)
            del got, want
        del x, a
    routes = {k: v - routes0[k] for k, v in block_route_counts(blk).items()}
    want_routes = {f"{name}_{route}": n for name in TC_KERNELS
                   for route, n in (("wgmma", 4), ("simt", 2),
                                    ("composed", 0))}
    print(f"  fused-block launches by route: {routes}", flush=True)
    if routes != want_routes:
        raise AssertionError(f"fused-block launches by route {routes}, want "
                             f"{want_routes}")

    rows = {}
    x = rand(B_MINIBATCH * N, W, dtype=torch.bfloat16)
    a = rand(B_MINIBATCH * N, W, dtype=torch.bfloat16)
    for name in BLOCK_KERNELS:
        kern, plain, seq = calls(name, x, a, p16)
        ms, ms_min = time_launches(kern)
        dev_ms = graph_ms(kern)
        plain_ms, _ = time_launches(plain, batches=3, per_batch=3, warm=1)
        seq_ms, _ = time_launches(seq)
        cost = block_cost(name, B_MINIBATCH, N, W, hidden, 2)
        bound_ms, bound_by = block_bound(*cost, "bfloat16")
        rk, _, rseq = calls(name, x[:B_ROLLOUT * N], a[:B_ROLLOUT * N], p16)
        roll_ms, _ = time_launches(rk)
        roll_dev_ms = graph_ms(rk)
        roll_seq_ms, _ = time_launches(rseq)
        roll_bound, _ = block_bound(
            *block_cost(name, B_ROLLOUT, N, W, hidden, 2), "bfloat16")
        plan = {k: v for k, v in blk.wgmma_plan(
            name, W, *tc_shape(name, W, hidden)).items() if v}
        print(f"  {name} B={B_MINIBATCH}: kernel {ms:.4f} ms (median of "
              f"{BATCHES} batches of {PER_BATCH}, min {ms_min:.4f}), card "
              f"alone {dev_ms:.4f} ms (parent {PARENT_MS[name][0]} ms at "
              f"B={B_MINIBATCH}, {PARENT_MS[name][1]} at B={B_ROLLOUT}); "
              f"plain {plain_ms:.3f} ms; unfused "
              f"sequence {seq_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.1f} GFLOP "
              f"products + {cost[2] / 1e9:.2f} GFLOP attention, bf16); "
              f"B={B_ROLLOUT}: kernel "
              f"{roll_ms:.4f} ms, card alone {roll_dev_ms:.4f} ms, unfused "
              f"{roll_seq_ms:.4f} ms, bound {roll_bound:.4f} ms; plan {plan} "
              f"[{smi}]", flush=True)
        rows[name] = dict(
            name=name, route="cuda",
            source="vit_marl_tpu_torch/ops/csrc/fused_block.cu",
            replaces=BLOCK_KERNELS[name][0],
            tolerance={"float32": F32_BLOCK_TOL,
                       "bfloat16": "rtol 1.6e-2, atol %d ulps of the "
                                   "output's largest magnitude" % (
                                       3 if name in ("fused_proj_mlp",
                                                     "fused_block_full")
                                       else 2)},
            max_abs_err=errs[name], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            device_ms=dev_ms, unfused_ms=seq_ms, ms_rollout=roll_ms,
            device_ms_rollout=roll_dev_ms, unfused_ms_rollout=roll_seq_ms,
            bound_ms_rollout=roll_bound,
            bf16_route="wgmma", plan=plan)
    return rows


def tc_shape(name, W, hidden):
    """The shape arguments of ``wgmma_plan`` / ``wgmma_info`` after the
    width at ViT-Small's shapes: (hidden, or K, or 0[, N, H])."""
    if name == "fused_ln_qkv":
        return (3 * W,)
    if name == "fused_proj_mlp":
        return (hidden,)
    return (hidden if name == "fused_block_full" else 0, ATT_N, ATT_H)


BLOCK_ROUTES = ("wgmma", "simt", "composed")


def block_route_counts(blk):
    """Calls of the fused-block functions by route (bf16: ``wgmma``,
    float32: ``simt``, past the kernels' widths: ``composed``)."""
    return {f"{name}_{route}": getattr(getattr(blk, name),
                                       f"launches_{route}")
            for name in TC_KERNELS for route in BLOCK_ROUTES}


def route_counts(attn):
    """The attention kernels' launches by direction and route."""
    return {f"{kind}_{route}": getattr(attn.short_attention,
                                       f"launches_{kind}_{route}")
            for kind in ("fwd", "bwd") for route in ("mma", "simt")}


def counters(attn, bkern, blk):
    """Every kernel's launch counter, by name: (get, reset) pairs."""
    def attr(obj, field):
        return (lambda: getattr(obj, field),
                lambda: setattr(obj, field, 0))
    out = {"book_scan": attr(bkern.process_step_aggs, "launches"),
           "book_scan_records": attr(bkern.process_step_records,
                                     "launches"),
           "short_attention_fwd": attr(attn.short_attention, "launches_fwd"),
           "short_attention_bwd": attr(attn.short_attention, "launches_bwd"),
           # not a kernel: the counted plain route past 32 tokens
           "long_attention": attr(attn.dot_product_attention, "calls")}
    for name in BLOCK_KERNELS:
        out[name] = attr(getattr(blk, name), "launches")
    return out


def debug_phase(torch, count, make_train, dev, smi, agg_train, agg_rate):
    """Train ``configs/ippo_2player.yaml`` with ``WORLD.DEBUG_MODE=true``
    (through the port's ``--set`` parser) for UPDATES updates; check losses,
    the launch counts (the records scan once a step of
    :func:`rollout_steps`, nothing else) and
    the trade log in the final state.  Then trains the aggregate path of
    phase 6 (``agg_train``, rate ``agg_rate`` there) once more, so the
    debug run has a warm aggregate run on either side.  Returns the counts
    of the debug run."""
    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.utils.cli import apply_set_overrides

    with open(CONFIG) as f:
        raw = yaml.safe_load(f)
    ma, tc = make_config(apply_set_overrides(raw, ["WORLD.DEBUG_MODE=true"]))
    if not ma.world.debug_mode:
        raise AssertionError("WORLD.DEBUG_MODE=true did not reach the world")
    train = make_train(ma, tc, device=dev)
    for _, reset in count.values():
        reset()
    torch.cuda.synchronize()
    tt = time.perf_counter()
    out = train(tc.seed, n_updates=UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tt
    got = {k: get() for k, (get, _) in count.items()}
    check_metrics(out["metrics"])
    want = {k: 0 for k in count}
    want["book_scan_records"] = rollout_steps(tc, UPDATES)
    if got != want:
        raise AssertionError(f"debug-mode launch counts {got}, want {want}")
    if train.env.rec_k != REC_KS[0]:
        raise AssertionError(f"debug log keeps {train.env.rec_k} fills per "
                             f"message, want {REC_KS[0]}")
    trades = out["state"].world.trades
    n_logged = int((trades[:, :, 0] != -1).sum())
    if trades.shape != (tc.num_envs, ma.world.n_trades, 8) or not n_logged:
        raise AssertionError(f"debug trade log {tuple(trades.shape)} holds "
                             f"{n_logged} trades")
    out_metrics = out["metrics"]
    steps = tc.num_envs * tc.num_steps * UPDATES
    del train, out, trades
    torch.cuda.synchronize()
    tt = time.perf_counter()
    agg_out = agg_train(tc.seed, n_updates=UPDATES)
    torch.cuda.synchronize()
    agg_wall = time.perf_counter() - tt
    print(f"  debug mode, rec_k={REC_KS[0]}: {UPDATES} updates x "
          f"NUM_STEPS={tc.num_steps} x NUM_ENVS={tc.num_envs}: {steps} "
          f"env-steps in {wall:.2f}s = {steps / wall:.0f} env-steps/s; "
          f"{update_split(out_metrics)}; launches "
          f"{ {k: v for k, v in got.items() if v} }; the last step's log "
          f"holds {n_logged} trades [{smi}]", flush=True)
    print(f"  aggregate path: {agg_rate:.0f} env-steps/s in phase 6, "
          f"{steps / agg_wall:.0f} after the debug run; "
          f"{update_split(agg_out['metrics'])} [{smi}]", flush=True)
    return got


def check_metrics(metrics, label=""):
    """Print each update's metrics; raise on a non-finite one."""
    for m in metrics:
        print("  " + " ".join(f"{k}={v:.5g}" for k, v in sorted(m.items())),
              flush=True)
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}non-finite metrics: {bad}")


def rollout_steps(tc, updates, halves=1):
    """The rollout steps of one ``train`` call of ``updates`` updates
    whose kernels the wrappers launch: under the loop every step, under
    the pipeline every half-batch step (``halves``); under the scan on
    the card (``ROLLOUT_MODE=auto``, the default, or ``scan``) only the
    warm-up step before the capture.  The graph's replays launch their
    kernels without the wrappers; :func:`traced_rollouts` counts
    them."""
    from vit_marl_tpu_torch.rl.ppo import rollout_mode

    if rollout_mode(tc.rollout_mode) == "scan" and DEV == "cuda":
        return 1
    return halves * tc.num_steps * updates


def vision_launches(tc, depth, updates, mode=None, halves=1):
    """The wrappers' kernel launches in ``updates`` updates of a ViT
    config: the book scan once a rollout step of :func:`rollout_steps`;
    each block's forward once such a step and once an update for the
    last value, the update's twice a minibatch (remat) and its backward
    once.  ``mode="long"``: past 32 tokens, the forwards on the counted
    plain route."""
    passes = tc.update_epochs * tc.num_minibatches * updates
    steps = rollout_steps(tc, updates, halves)
    forward = depth * (steps + updates) + depth * 2 * passes
    want = {"book_scan": steps}
    if mode == "long":
        want["long_attention"] = forward
    elif mode is None:
        want["short_attention_fwd"] = forward
        want["short_attention_bwd"] = depth * passes
    elif mode == "attn_ln_fold":
        want["fused_ln_qkv_attn"] = forward
        want["short_attention_bwd"] = depth * passes
    elif mode == "fused_block":
        want["fused_ln_qkv"] = want["fused_proj_mlp"] = forward
    else:
        want["fused_block_full"] = forward
    return want


def drive(torch, count, fn):
    """Run ``fn()`` with every launch count set to 0 just before it; returns
    (its result, the counts just after, seconds)."""
    for _, reset in count.values():
        reset()
    torch.cuda.synchronize()
    tt = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: get() for k, (get, _) in count.items()}, \
        time.perf_counter() - tt


def expect(got, want, label):
    full = {k: 0 for k in got}
    full.update(want)
    if got != full:
        raise AssertionError(f"{label}: launch counts {got}, want {full}")


def bench_phase(torch, attn, bkern, blk, smi):
    """The port's bench in-process (``vit_marl_tpu_torch/bench.py``): the
    loop with GRU and ViT-Small policies at 4,096 envs x 10 steps x 2
    reps, ``--vit-images`` and ``--selfcheck``; each JSON line must parse
    with a value > 0 (true), each loop's launches must be exact.  Returns
    the four result dicts."""
    from vit_marl_tpu_torch import bench

    count = counters(attn, bkern, blk)
    depth, steps = 12, 1 + 10 * 2             # ViT-Small; warm-up + timed
    iters = 1 + max(2 * 4, 8)                 # --vit-images: warm-up + timed
    # the bench builds its world, whose window table takes one scan
    runs = [("gru", ["--policy", "gru"], {"book_scan": 1 + steps}),
            ("vit-small", ["--policy", "vit-small"],
             {"book_scan": 1 + steps, "short_attention_fwd": depth * steps}),
            ("vit-images", ["--vit-images"],
             {"short_attention_fwd": depth * 2 * iters,
              "short_attention_bwd": depth * iters}),
            ("selfcheck", ["--selfcheck"], None)]
    results = {}
    for label, argv, want in runs:
        buf = io.StringIO()
        routes0 = route_counts(attn)
        try:
            with contextlib.redirect_stdout(buf):
                out, got, wall = drive(torch, count, lambda: bench.main(
                    BENCH_ARGS + argv))
        except SystemExit as e:
            raise AssertionError(f"bench {label} exited {e.code}: "
                                 f"{buf.getvalue().strip()}") from None
        line = buf.getvalue().strip().splitlines()[-1]
        parsed = json.loads(line)
        if parsed != out or not parsed["value"] or parsed["value"] < 0:
            raise AssertionError(f"bench {label}: {line}")
        if want is not None:
            expect(got, want, f"bench {label}")
            routes = {k: v - routes0[k] for k, v in route_counts(attn).items()}
            if routes["fwd_simt"] or routes["bwd_simt"]:
                raise AssertionError(f"bench {label}: attention on the "
                                     f"float32 route {routes}")
        results[label] = parsed
        print(f"  bench {label}: {line} ({wall:.2f}s; launches "
              f"{ {k: v for k, v in got.items() if v} }) [{smi}]",
              flush=True)
    return results


def learner_state(learners):
    """Copies of each learner's weights, Adam moments and step count."""
    from vit_marl_tpu_torch.rl.checkpoint import adam_state
    return [({k: v.clone() for k, v in lr.net.state_dict().items()},
             {k: [t.clone() for t in v]
              for k, v in adam_state(lr.opt).items()}, lr.count)
            for lr in learners]


def resume_phase(torch, attn, bkern, blk, make_train, load_yaml_config, dev,
                 smi):
    """``configs/ippo_vision_simplest.yaml``: 2 updates with
    ``CHECKPOINT_DIR`` in a temporary directory, then ``RESUME=true`` for
    one more; the weights, Adam moments and step counts of the resumed
    trainer (``train(seed, n_updates=0)``: restored, no update run) must
    equal the saved ones, the update index must continue at 2, the losses
    must be finite and the resumed update's launches exact."""
    from vit_marl_tpu_torch.rl.checkpoint import CheckpointManager

    ma, tc = load_yaml_config(SIMPLEST_CONFIG)
    count = counters(attn, bkern, blk)
    with tempfile.TemporaryDirectory() as d:
        tc = dataclasses.replace(tc, checkpoint_dir=d, log_backend="none")
        train = make_train(ma, tc, device=dev)
        first = train(tc.seed, n_updates=UPDATES)
        saved = learner_state(first["learners"])
        resumed = make_train(ma, dataclasses.replace(tc, resume=True),
                             env=train.env)
        # the entry point's own restore: no update run, its learners held
        # against the saved ones
        restored = resumed(tc.seed, n_updates=0)
        for (w0, a0, c0), (w1, a1, c1) in zip(
                saved, learner_state(restored["learners"])):
            same = (c0 == c1 and all(torch.equal(w0[k], w1[k]) for k in w0)
                    and all(torch.equal(x, y) for k in a0
                            for x, y in zip(a0[k], a1[k])))
            if not same:
                raise AssertionError("resume: restored state differs from "
                                     "the saved state")
        out, got, wall = drive(torch, count,
                               lambda: resumed(tc.seed, n_updates=1))
        steps = [m["update_step"] for m in out["metrics"]]
        kept = CheckpointManager(d).all_steps()
    check_metrics(out["metrics"], "resume: ")
    if restored["metrics"] or steps != [UPDATES] or kept != [1, 2]:
        raise AssertionError(f"resume: restore ran {restored['metrics']}, "
                             f"then {steps}; checkpoints {kept}")
    expect(got, vision_launches(tc, 12, 1), "resume")
    n_saved = sum(len(w) for w, _, _ in saved)
    print(f"  saved updates 0-1, restored {n_saved} tensors and the Adam "
          f"state exactly, resumed at update {steps[0]} in {wall:.2f}s "
          f"({update_split(out['metrics'])}); checkpoints kept {kept} "
          f"[{smi}]", flush=True)


def lobster_phase(torch, attn, bkern, blk, make_train, dev, smi):
    """``configs/ippo_2player.yaml`` fed by LOBSTER CSVs written from a
    synthetic day (``WORLD.DATA_PATH``; the native parser built from
    ``native/lobster_parser.cpp``): one update at 1,024 envs, finite
    losses, the book scan's launches exact."""
    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.data import native
    from vit_marl_tpu_torch.data.synthetic import generate_day, write_day_csvs
    from vit_marl_tpu_torch.utils.cli import apply_set_overrides

    count = counters(attn, bkern, blk)
    with tempfile.TemporaryDirectory() as d:
        day = generate_day(seed=SEED, n_messages=30_000)
        paths = write_day_csvs(day, os.path.join(d, "SYNTH", "2024-01"))
        with open(CONFIG) as f:
            raw = yaml.safe_load(f)
        ma, tc = make_config(apply_set_overrides(raw, [
            f"WORLD.DATA_PATH={d}", "WORLD.STOCK=SYNTH",
            "WORLD.TIME_PERIOD=2024-01", "NUM_ENVS=1024",
            "LOG_BACKEND=none"]))
        tl = time.perf_counter()
        train = make_train(ma, tc, device=dev)
        load_s = time.perf_counter() - tl
    parser = "native" if native.get_native_module() is not None else "numpy"
    out, got, wall = drive(torch, count, lambda: train(tc.seed, n_updates=1))
    check_metrics(out["metrics"], "LOBSTER: ")
    expect(got, {"book_scan": rollout_steps(tc, 1)}, "LOBSTER")
    print(f"  {os.path.basename(paths[0])}: {len(day.messages)} messages, "
          f"{train.env.n_windows} windows, loaded in {load_s:.2f}s "
          f"({parser} parser); 1 update x NUM_STEPS={tc.num_steps} x "
          f"NUM_ENVS={tc.num_envs} in {wall:.2f}s "
          f"({update_split(out['metrics'])}) [{smi}]", flush=True)


def wide_block_phase(torch, attn, blk, smi):
    """One bf16 block of each fused mode at ViT-Base's width (W=768, 12
    heads, hidden 3,072, B=1,024 images) forward and backward: every
    fused call on the composed route and none on a kernel, counted
    exactly; the forward against the plain versions and the gradients
    against autograd of the composition the JAX package differentiates,
    at ``block_tol`` (float32 gradients at that of their bf16
    rounding).  Times each mode."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    N, W, H, B = ATT_N, BASE_W, BASE_H, B_BASE
    p = block_params(gen, torch.bfloat16, W, MLP_RATIO * W)
    x = torch.randn((B * N, W), generator=gen, device=dev).to(torch.bfloat16)
    gout = torch.randn((B * N, W), generator=gen,
                       device=dev).to(torch.bfloat16)
    names = ("g1", "b1", "wqkv", "bqkv", "wp", "bp", "g2", "b2", "w1", "bm1",
             "w2", "bm2")
    xla = attn.attention_reference_xla

    def fused(mode, t, q):
        if mode == "fused_block_full":
            return blk.fused_block_full(t, *q, N, H)
        if mode == "fused_block":
            return blk.fused_proj_mlp(
                xla(blk.fused_ln_qkv(t, *q[:4]), N, H), t, *q[4:])
        return blk.fused_ln_qkv_attn(t, *q[:4], N, H)

    def plain(mode, t, q):
        if mode == "fused_block_full":
            return blk.full_block_reference(t, *q, N, H)
        if mode == "fused_block":
            return blk.proj_mlp_reference(
                xla(blk.ln_qkv_reference(t, *q[:4]), N, H), t, *q[4:])
        return blk.ln_qkv_attn_reference(t, *q[:4], N, H)

    def differentiated(mode, t, q):
        """The composition the wrappers' backwards differentiate."""
        if mode == "fused_block_full":
            return blk._full_block_xla(t, *q, N, H)
        if mode == "fused_block":
            return plain(mode, t, q)
        return xla(blk.ln_qkv_reference(t, *q[:4]), N, H)

    want_routes = {"fused_block_full": ("fused_block_full",),
                   "fused_block": ("fused_ln_qkv", "fused_proj_mlp"),
                   "attn_ln_fold": ("fused_ln_qkv_attn",)}
    errs, times = {}, {}
    for mode, fns in want_routes.items():
        used = 12 if mode != "attn_ln_fold" else 4
        leaves = [x] + [p[k] for k in names[:used]]
        ins = [t.clone().requires_grad_(True) for t in leaves]
        routes0, att0 = block_route_counts(blk), route_counts(attn)
        out = fused(mode, ins[0], ins[1:])
        got = torch.autograd.grad(out, ins, gout)
        torch.cuda.synchronize()
        routes = {k: v - routes0[k]
                  for k, v in block_route_counts(blk).items()}
        want = {k: 0 for k in routes}
        for name in fns:
            want[f"{name}_composed"] = 1
        att = {k: v - att0[k] for k, v in route_counts(attn).items()}
        want_att = {k: 0 for k in att}
        if mode == "attn_ln_fold":
            want_att["bwd_mma"] = 1
        if routes != want or att != want_att:
            raise AssertionError(f"W={W} {mode}: fused calls by route "
                                 f"{routes}, attention {att}; want {want}, "
                                 f"{want_att}")
        ref = [t.clone().requires_grad_(True) for t in leaves]
        fwd = plain(mode, ref[0], ref[1:]).detach()
        grads = torch.autograd.grad(differentiated(mode, ref[0], ref[1:]),
                                    ref, gout)
        name = fns[-1]
        out = out.detach()
        err = float((out.float() - fwd.float()).abs().max())
        torch.testing.assert_close(out, fwd, **block_tol(name, fwd),
                                   msg=lambda m: f"W={W} {mode}: {m}")
        for i, (a, b) in enumerate(zip(got, grads)):
            tol = block_tol(name, b.to(torch.bfloat16))
            torch.testing.assert_close(
                a.float(), b.float(), **tol,
                msg=lambda m: f"W={W} {mode} gradient {i}: {m}")
        errs[mode] = err
        det = [t.detach() for t in leaves]
        with torch.no_grad():
            fwd_ms, _ = time_launches(lambda: fused(mode, det[0], det[1:]),
                                      batches=5, per_batch=5, warm=2)

        def step():
            xs = [t.requires_grad_(True) for t in (u.clone() for u in det)]
            torch.autograd.grad(fused(mode, xs[0], xs[1:]), xs, gout)

        step_ms, _ = time_launches(step, batches=3, per_batch=3, warm=1)
        times[mode] = (fwd_ms, step_ms)
        calls = {k: v for k, v in routes.items() if v}
        print(f"  W={W} {mode}: forward max abs err {err:.3g}, gradients "
              f"within block_tol; calls {calls}; forward {fwd_ms:.4f} ms, "
              f"forward + backward {step_ms:.3f} ms at B={B} [{smi}]",
              flush=True)
        del ins, got, ref, grads, out, fwd
    return errs, times


def entry_phase(torch, attn, bkern, blk, smi):
    """The entry module's forward step of the flagship (ViT-Tiny, bf16,
    32 actors) on the card: shapes and finite values, the attention
    kernel once a block, and the same weights on the CPU's plain path
    within 2e-2 (bf16)."""
    from vit_marl_tpu_torch.graft_entry import entry

    count = counters(attn, bkern, blk)
    fn, args = entry()
    got, launches, wall = drive(torch, count, lambda: fn(*args))
    expect(launches, {"short_attention_fwd": 12}, "entry")
    cfn, cargs = entry("cpu")
    cfn.net.load_state_dict({k: v.cpu() for k, v in
                             fn.net.state_dict().items()})
    want = cfn(*cargs)
    for name, a, b in zip(("h2", "mode", "value"), got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"entry {name}: {tuple(a.shape)}")
        torch.testing.assert_close(a.cpu(), b, rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"entry {name}: {m}")
    print(f"  entry(): h2 {tuple(got[0].shape)}, mode {tuple(got[1].shape)},"
          f" value {tuple(got[2].shape)} in {wall * 1e3:.2f} ms (first "
          f"call); within 2e-2 of the CPU [{smi}]", flush=True)


def info_reduce_kernels(torch, env, smi):
    """The card's kernels of one step's info reduction
    (``rl/ppo.py::_reduce_info``) at the world's batch, from
    ``torch.profiler``, beside the host ms a call."""
    from torch.profiler import ProfilerActivity, profile

    from vit_marl_tpu_torch.rl.ppo import _reduce_info

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = env.default_params
    E = E_MAIN
    _, state = env.reset(env.draw_reset(E, gen), params)
    info = env.step_vec(state, random_actions(torch, env, E, gen), params,
                        generator=gen)[4]
    ms = host_ms(lambda: _reduce_info(info))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _reduce_info(info)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    n_buf = sum(len(inf.buffers) for inf in [info["world"]]
                + list(info["agents"]))
    print(f"  one step's info reduction at E={E}: {n} card kernels "
          f"(torch.profiler; {n_buf} info buffers), host {ms:.4f} ms a "
          f"call [{smi}]", flush=True)
    return n


def space_world(name, **world):
    """The port's world of ``SPACE_WORLDS[name]`` on the card."""
    from vit_marl_tpu_torch import config as c
    from vit_marl_tpu_torch.env.world import WorldEnv

    agents, n, fields = SPACE_WORLDS[name]
    cfgs = tuple((c.MarketMakingConfig if kind == "mm" else
                  c.ExecutionConfig)(short_name=f"{kind.upper()}{i}", **kw)
                 for i, (kind, kw) in enumerate(agents))
    ma = c.MultiAgentConfig(world=c.WorldConfig(**dict(fields, **world)),
                            agents=cfgs, n_agents_per_type=n)
    return WorldEnv(ma, device=DEV)


def random_actions(torch, env, E, gen):
    """Actions inside each type's space, on the card."""
    from vit_marl_tpu_torch.env import spaces

    out = []
    for sp, n in zip(env.action_spaces, env.n_per_type):
        lead = (E,) if n == 1 else (E, n)
        if isinstance(sp, spaces.Discrete):
            out.append(torch.randint(0, sp.n, lead, generator=gen,
                                     device=gen.device))
        elif sp.dtype == torch.int32:
            out.append(torch.randint(sp.low, sp.high + 1, lead + sp.shape,
                                     generator=gen, device=gen.device,
                                     dtype=torch.int32))
        else:
            low, high = (torch.as_tensor(b, device=gen.device)
                         for b in (sp.low, sp.high))
            u = torch.rand(lead + sp.shape, generator=gen,
                           device=gen.device)
            out.append(low + u * (high - low))
    return out


def compare_steps(torch, got, want, label):
    """A step through the kernel against the same step through the plain
    scan: integer and bool leaves equal, float leaves within 1e-5."""
    from vit_marl_tpu_torch.utils.tree import tree_map

    bad = []

    def check(a, b):
        if a.dtype.is_floating_point:
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-5,
                                  equal_nan=True):
                bad.append(float((a - b).abs().nan_to_num().max()))
        elif not torch.equal(a, b):
            bad.append(int((a.long() - b.long()).abs().max()))
        return a

    obs, state, rew, done, _ = got
    wobs, wstate, wrew, wdone, _ = want
    tree_map(check, (obs, state, rew, done["agents"], done["__all__"]),
             (wobs, wstate, wrew, wdone["agents"], wdone["__all__"]))
    if bad:
        raise AssertionError(f"{label}: kernel step != plain step ({bad})")


def spaces_phase(torch, count, bkern, smi):
    """Each world of ``SPACE_WORLDS``: SPACE_STEPS steps at E_MAIN envs
    (the book scan once a step), then one step of the first E_CHECK envs'
    state with the same actions and draws through the kernel and through
    the plain scan.  Kernel 1 timed at M=126 beside its bound; kernel 2
    checked there in debug_mode (the world's step and the scan alone).
    Returns the M=126 numbers."""
    from vit_marl_tpu_torch.env import world as world_mod
    from vit_marl_tpu_torch.utils.tree import tree_map

    out = {}
    for name in SPACE_WORLDS:
        env = space_world(name)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED)
        params = env.default_params
        _, state = env.reset(env.draw_reset(E_MAIN, gen), params)

        def run():
            st = state
            for _ in range(SPACE_STEPS):
                st = env.step_vec(st, random_actions(torch, env, E_MAIN, gen),
                                  params, generator=gen)[1]
            return st
        state, got, wall = drive(torch, count, run)
        expect(got, {"book_scan": SPACE_STEPS}, f"world {name!r}")
        sub = tree_map(lambda v: v[:E_CHECK], state)
        acts = random_actions(torch, env, E_CHECK, gen)
        draws = env.draw_step(E_CHECK, gen)
        with_kernel = env.step_vec(sub, acts, params, draws=draws)
        kernel_scan = world_mod.process_step_aggs
        world_mod.process_step_aggs = bkern.process_step_aggs_reference
        try:
            plain = env.step_vec(sub, acts, params, draws=draws)
        finally:
            world_mod.process_step_aggs = kernel_scan
        compare_steps(torch, with_kernel, plain, f"world {name!r}")
        combined, _ = env._build_messages(sub, env._actions(acts), params,
                                          draws.shuffle, draws.agents)
        zeroed = int(((combined[:, :, 0] == 0) & (combined[:, :, 6] != 0))
                     .sum())
        if name == "fixed_time" and not zeroed:
            raise AssertionError("the fixed_time stream holds no data rows "
                                 "zeroed past the episode's end")
        print(f"  world {name!r}: M={env.num_msgs_per_step}, "
              f"{len(env.agent_types)} agent types "
              f"{[a.cfg.action_space for a in env.agent_types]}, obs "
              f"{[tuple(s.shape) for s in env.observation_spaces]}; "
              f"{SPACE_STEPS} steps at E={E_MAIN} in {wall:.2f}s, launches "
              f"{ {k: v for k, v in got.items() if v} }; E={E_CHECK}: kernel "
              f"step = plain step ({zeroed} zeroed data rows) [{smi}]",
              flush=True)
        if name == "m126":
            out = m126_checks(torch, bkern, world_mod, env, state, params,
                              gen, smi)
        del env, state, sub, with_kernel, plain
    return out


def m126_checks(torch, bkern, world_mod, env, state, params, gen, smi):
    """Kernel 1 at M=126, E=E_MAIN on the world's own stream, timed beside
    its bound and its plain version; kernel 2 on the same stream (rec_k
    16) against its plain version, and the debug_mode world's step at
    E=E_CHECK through the records kernel and through its plain version."""
    if env.num_msgs_per_step != M_SPACES:
        raise AssertionError(f"m126 world: M={env.num_msgs_per_step}")
    acts = random_actions(torch, env, E_MAIN, gen)
    draws = env.draw_step(E_MAIN, gen)
    combined, _ = env._build_messages(state, env._actions(acts), params,
                                      draws.shuffle, draws.agents)
    books = state.world.books
    prev = torch.stack([state.world.best_asks[:, -1, 0],
                        state.world.best_bids[:, -1, 0]], 1)
    tids = torch.cat([p.trader_id for p in params.agents])
    cfg = env.wcfg
    got = bkern.process_step_aggs(cfg, combined, books, tids, prev, TICK,
                                  draws.uniforms)
    want = bkern.process_step_aggs_reference(cfg, combined, books, tids,
                                             prev, TICK, draws.uniforms)
    pairs = [(got[0].data, want[0].data), (got[1][0], want[1][0]),
             (got[1][1], want[1][1]), (got[2][0], want[2][0]),
             (got[2][1], want[2][1])]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("kernel 1 != plain at M=126")
    ms, ms_min = time_launches(lambda: bkern.process_step_aggs(
        cfg, combined, books, tids, prev, TICK, draws.uniforms))
    torch.cuda.synchronize()
    tp = time.perf_counter()
    bkern.process_step_aggs_reference(cfg, combined, books, tids, prev,
                                      TICK, draws.uniforms)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tp) * 1e3
    nbytes = scan_bytes(E_MAIN, M_SPACES, cfg.n_orders, len(tids))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  kernel 1 at M={M_SPACES}, E={E_MAIN}, {len(tids)} traders: "
          f"bit-equal to plain; {ms:.4f} ms per launch (min {ms_min:.4f}); "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s) [{smi}]", flush=True)
    rk = REC_KS[0]
    rgot = bkern.process_step_records(cfg, combined, books, prev, rk,
                                      draws.uniforms)
    rwant = bkern.process_step_records_reference(cfg, combined, books, prev,
                                                 rk, draws.uniforms)
    flat = lambda r: [r[0].data, *r[1], *r[2]]   # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(flat(rgot), flat(rwant))):
        raise AssertionError(f"kernel 2 != plain at M={M_SPACES}")
    denv = space_world("m126", debug_mode=True)
    dparams = denv.default_params
    _, dstate = denv.reset(denv.draw_reset(E_CHECK, gen), dparams)
    dacts = random_actions(torch, denv, E_CHECK, gen)
    ddraws = denv.draw_step(E_CHECK, gen)
    launches = bkern.process_step_records.launches
    with_kernel = denv.step_vec(dstate, dacts, dparams, draws=ddraws)
    if bkern.process_step_records.launches != launches + 1:
        raise AssertionError("the debug_mode step did not launch kernel 2")
    kernel_scan = world_mod.process_step_records
    world_mod.process_step_records = bkern.process_step_records_reference
    try:
        plain = denv.step_vec(dstate, dacts, dparams, draws=ddraws)
    finally:
        world_mod.process_step_records = kernel_scan
    compare_steps(torch, with_kernel, plain, "debug_mode world, M=126")
    if not torch.equal(with_kernel[4]["world"]["trades"],
                       plain[4]["world"]["trades"]):
        raise AssertionError("debug_mode trade logs differ at M=126")
    n_fills = int((with_kernel[4]["world"]["trades"][:, :, 0] != -1).sum())
    print(f"  kernel 2 at M={M_SPACES}: records (rec_k {rk}) bit-equal to "
          f"plain at E={E_MAIN}; the debug_mode world's step at "
          f"E={E_CHECK} equal through the kernel and the plain scan, "
          f"{n_fills} trades logged [{smi}]", flush=True)
    return dict(ms_m126=ms, plain_ms_m126=plain_ms, bound_ms_m126=bound_ms,
                bit_equal_m126=True)


def sweep_fine_phase(torch, count, make_train, smi):
    """One update of ``sweep_fine.yaml``'s base run."""
    with open(SWEEP_CONFIG) as f:
        raw = yaml.safe_load(f)
    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.rl.sweep import split_sweep

    ma, tc = make_config(split_sweep(raw)[0])
    out, got, wall = drive(torch, count, lambda: make_train(
        ma, tc, device=DEV)(tc.seed, n_updates=1))
    expect(got, {"book_scan": 1 + rollout_steps(tc, 1)},
           "sweep_fine base run (window table + steps)")
    check_metrics(out["metrics"], "sweep_fine: ")
    m = out["metrics"][0]
    steps = tc.num_envs * tc.num_steps
    print(f"  sweep_fine base run (MM {ma.agents[0].observation_space}, "
          f"EXE {ma.agents[1].action_space} + "
          f"{ma.agents[1].observation_space}): 1 update x {tc.num_steps} "
          f"steps x {tc.num_envs} envs: {steps / m['rollout_s']:.0f} "
          f"env-steps/s in the rollout, rollout_s {m['rollout_s']:.3f}, "
          f"update_s {m['update_s']:.3f}; book-scan launches "
          f"{got['book_scan']} (the rollout's + the window table) [{smi}]",
          flush=True)


def update_split(metrics):
    return "; ".join(f"update {int(m['update_step'])}: rollout "
                     f"{m['rollout_s']:.2f}s + PPO {m['update_s']:.2f}s"
                     for m in metrics)


def vision_phase(torch, attn, bkern, blk, make_train, load_yaml_config, dev,
                 smi, mode=None, config=VISION_CONFIG, updates=UPDATES,
                 epochs=None):
    """Train a ViT config for ``updates`` updates on the card, with the
    default blocks or in the fused-block ``mode`` (``epochs``: PPO epochs
    an update, where not the config's); check losses and the launch
    count of every kernel.  Returns the counts of the run."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    ma, tc = load_yaml_config(config)
    if mode is not None:
        tc = dataclasses.replace(tc, **{f"vit_{mode}": True})
    if epochs is not None:
        tc = dataclasses.replace(tc, update_epochs=epochs)
    depth = VIT_PRESETS[tc.vit_preset].depth
    train = make_train(ma, tc, device=dev)
    count = counters(attn, bkern, blk)
    for _, reset in count.values():
        reset()
    routes = route_counts(attn)
    block_routes = block_route_counts(blk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tt = time.perf_counter()
    out = train(tc.seed, n_updates=updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tt
    got = {k: get() for k, (get, _) in count.items()}
    check_metrics(out["metrics"])
    want = {k: 0 for k in count}
    want.update(vision_launches(tc, depth, updates, mode))
    if got != want:
        raise AssertionError(f"launch counts {got}, want {want}")
    routes = {k: v - routes[k] for k, v in route_counts(attn).items()}
    want_routes = {k: 0 for k in routes}
    want_routes["fwd_mma"] = want["short_attention_fwd"]
    want_routes["bwd_mma"] = want["short_attention_bwd"]
    if routes != want_routes:
        raise AssertionError(f"the bf16 ViT's attention launches by route "
                             f"{routes}, want {want_routes}")
    block_routes = {k: v - block_routes[k]
                    for k, v in block_route_counts(blk).items()}
    want_block = {f"{k}_{route}": want[k] if route == "wgmma" else 0
                  for k in TC_KERNELS for route in BLOCK_ROUTES}
    if block_routes != want_block:
        raise AssertionError(f"the bf16 ViT's fused-block launches by route "
                             f"{block_routes}, want {want_block}")
    steps = tc.num_envs * tc.num_steps * updates
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = update_split(out["metrics"])
    nonzero = {k: v for k, v in got.items() if v}
    print(f"  {os.path.basename(config)}: "
          f"ViT-{tc.vit_preset} depth {depth}, mode {mode or 'default'}, "
          f"{updates} updates x NUM_STEPS={tc.num_steps} x NUM_ENVS="
          f"{tc.num_envs}: {steps} env-steps in {wall:.2f}s = "
          f"{steps / wall:.0f} env-steps/s; {split}; peak memory "
          f"{peak:.2f} GiB; launches {nonzero} [{smi}]", flush=True)
    return got


def config_with(path, sets):
    """A committed config with ``--set`` overrides (the port's parser)."""
    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.utils.cli import apply_set_overrides

    with open(path) as f:
        raw = yaml.safe_load(f)
    return make_config(apply_set_overrides(raw, sets))


def train_once(torch, count, make_train, ma, tc, want, label, smi,
               **kw):
    """One update of a config on the card with every count set to 0 just
    before it; the losses finite and the launches exactly ``want``.
    Returns (the update's metrics, the counts, the trainer, its
    networks)."""
    train = make_train(ma, tc, device=DEV, **kw)
    out, got, wall = drive(torch, count, lambda: train(tc.seed, n_updates=1))
    m = out["metrics"][0]
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")
    expect(got, want, label)
    steps = tc.num_envs * tc.num_steps
    losses = ", ".join(f"{k}={v:.5g}" for k, v in sorted(m.items())
                       if k.endswith(("/total_loss", "/mean_reward")))
    print(f"  {label}: 1 update x {tc.num_steps} steps x {tc.num_envs} "
          f"envs in {wall:.2f}s ({steps / wall:.0f} env-steps/s; rollout "
          f"{m['rollout_s']:.2f}s, PPO {m['update_s']:.2f}s); {losses}; "
          f"launches { {k: v for k, v in got.items() if v} } [{smi}]",
          flush=True)
    return m, got, train, out["networks"]


def layouts_check(torch, count, smi):
    """The ViT-Small encoder (bf16) forward and backward at B_ROLLOUT
    images on the same weights in three forms: flat rows with the
    attention kernels (the default), flat rows with the XLA-form
    attention (``attn_kernel=False``) and ``(B, N, W)`` tokens
    (``rows_2d=False``, which takes the XLA-form attention by layout, as
    the JAX package's MHA does).  The flat rows launch the kernels (twice
    a block forward under remat, once backward), the other two none.
    The rank-3 layout's embeddings agree with the flat XLA-form ones
    within ``block_tol`` of the bf16-rounded output (the same math in
    another layout), and one block of each layout with its default
    attention (kernel against XLA form) within ``block_tol``; the whole
    encoder's difference between the two attention routes (P in float32
    against P rounded to bf16, over 12 blocks) is printed.  Returns the
    counts of the kernel and rank-3 runs."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTEncoder

    torch.manual_seed(SEED)
    cfg = VIT_PRESETS["small"]
    encs = {"flat rows": ViTEncoder(cfg, ATT_N - 1).to(DEV)}
    for label, kw in (("flat rows, XLA-form attention",
                       dict(attn_kernel=False)),
                      ("(B, N, W) tokens", dict(rows_2d=False))):
        encs[label] = ViTEncoder(dataclasses.replace(cfg, **kw),
                                 ATT_N - 1).to(DEV)
        encs[label].load_state_dict(encs["flat rows"].state_dict(),
                                    strict=True)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    img = 3 * torch.randn((B_ROLLOUT, ATT_N - 1, 3, 2), generator=gen,
                          device=DEV)
    w = torch.randn((B_ROLLOUT, cfg.width), generator=gen, device=DEV) / 32
    res = {}
    for label, enc in encs.items():
        def run(enc=enc):
            enc.zero_grad(set_to_none=True)
            y = enc(img)
            (y * w).sum().backward()
            return y.detach(), {k: p.grad.clone()
                                for k, p in enc.named_parameters()}
        run()                        # untimed: first calls' set-up
        res[label] = drive(torch, count, run)
    depth = cfg.depth
    (yk, gk), got_k, tk = res["flat rows"]
    (yx, gx), got_x, tx = res["flat rows, XLA-form attention"]
    (y3, g3), got_3, t3 = res["(B, N, W) tokens"]
    expect(got_k, {"short_attention_fwd": 2 * depth,
                   "short_attention_bwd": depth}, "encoder, flat rows")
    expect(got_x, {}, "encoder, flat rows, XLA-form attention")
    expect(got_3, {}, "encoder, (B, N, W) tokens")
    tol = block_tol("fused_ln_qkv", yx.to(torch.bfloat16))
    if not torch.allclose(y3, yx, **tol):
        raise AssertionError(
            f"encoder layouts differ: max abs "
            f"{float((y3 - yx).abs().max())}, tolerance {tol}")
    if not all(torch.isfinite(g).all() for g in g3.values()):
        raise AssertionError("encoder, (B, N, W) tokens: non-finite grads")

    def grad_diff(a, b):
        num = torch.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
        return float(num / torch.sqrt(sum((b[k] ** 2).sum() for k in b)))

    # one block, each layout on its own attention route
    x = torch.randn((B_ROLLOUT * ATT_N, cfg.width), generator=gen,
                    device=DEV).to(torch.bfloat16)
    with torch.no_grad():
        bk_out, got_b, _ = drive(torch, count, lambda: encs["flat rows"]
                                 .blocks[0](x, ATT_N))
        b3_out = encs["(B, N, W) tokens"].blocks[0](
            x.reshape(B_ROLLOUT, ATT_N, -1), ATT_N).reshape(bk_out.shape)
    expect(got_b, {"short_attention_fwd": 1}, "one block, flat rows")
    btol = block_tol("fused_block_full", bk_out)
    if not torch.allclose(b3_out.float(), bk_out.float(), **btol):
        raise AssertionError(
            f"one block: layouts differ by "
            f"{float((b3_out.float() - bk_out.float()).abs().max())}, "
            f"tolerance {btol}")
    print(f"  ViT-Small encoder, bf16, B={B_ROLLOUT}, forward + backward: "
          f"flat rows {tk * 1e3:.1f} ms (launches "
          f"{ {k: v for k, v in got_k.items() if v} }), flat rows with the "
          f"XLA-form attention {tx * 1e3:.1f} ms, (B, N, W) tokens "
          f"{t3 * 1e3:.1f} ms (no kernel launch); (B, N, W) against flat "
          f"XLA-form: embeddings max abs "
          f"{float((y3 - yx).abs().max()):.4g} (tolerance {tol}), "
          f"gradients' relative difference {grad_diff(g3, gx):.3g}; one "
          f"block, (B, N, W) against flat rows' kernel: max abs "
          f"{float((b3_out.float() - bk_out.float()).abs().max()):.4g} "
          f"(tolerance {btol}); the whole encoder, (B, N, W) against "
          f"flat rows' kernel: embeddings max abs "
          f"{float((y3 - yk).abs().max()):.4g}, gradients' relative "
          f"difference {grad_diff(g3, gk):.3g} (P rounded to bf16 "
          f"against P in float32, over {depth} blocks) [{smi}]",
          flush=True)
    return got_k, got_3


def pipeline_bench(torch, count, smi):
    """The bench at 4,096 envs with ViT-Small in ``loop``,
    ``pipeline-seq`` and ``pipeline`` modes (10 steps x 2 reps after one
    untimed run); the launches of each exact; ``pipeline`` bit-equal to
    ``pipeline-seq`` in the last run's observations and every step's
    actions.  Returns the three rates."""
    from vit_marl_tpu_torch import bench
    from vit_marl_tpu_torch.utils.tree import tree_leaves

    depth, rates, finals = 12, {}, {}
    for mode in ("loop", "pipeline-seq", "pipeline"):
        args = bench.parse_args(BENCH_ARGS + ["--policy", "vit-small",
                                              "--mode", mode])
        out, got, wall = drive(torch, count,
                               lambda: bench.measure(args, torch.device(DEV)))
        if mode == "loop":
            steps = 1 + args.steps * args.reps
            want = {"book_scan": 1 + steps,
                    "short_attention_fwd": depth * steps}
        else:
            steps = args.steps * (1 + args.reps)
            want = {"book_scan": 1 + 2 * steps,
                    "short_attention_fwd": depth * 2 * steps}
            finals[mode] = tree_leaves(out["final"])
        expect(got, want, f"bench {mode}")
        rates[mode] = out["value"]
        print(f"  bench [vit-small,{mode}]: {out['value']:.1f} env-steps/s "
              f"({out['detail']}; {wall:.2f}s with the world's set-up; "
              f"launches { {k: v for k, v in got.items() if v} }) [{smi}]",
              flush=True)
    a, b = finals["pipeline"], finals["pipeline-seq"]
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("bench: pipeline (two streams) != "
                             "pipeline-seq (one stream)")
    print(f"  pipeline on two streams bit-equal to pipeline-seq: "
          f"{len(a)} tensors (both halves' observations, every step's "
          f"actions); pipeline / pipeline-seq = "
          f"{rates['pipeline'] / rates['pipeline-seq']:.4f}, pipeline / "
          f"loop = {rates['pipeline'] / rates['loop']:.4f} [{smi}]",
          flush=True)
    return rates


def mesh_scan_checks(torch, bkern, env, state, params, gen, smi):
    """Kernel 1 at the mesh config's shape (E=MESH_ENVS, M=220, 20
    traders, the general kernel whose per-trader sums live in shared
    memory): its launch plan; bit-equal to its plain version on seeded
    streams in all four cancel modes and on the world's own stream; its
    time beside its bound and its plain version."""
    from torch_cases import make_case
    from vit_marl_tpu_torch.config import EngineConfig

    tids = torch.cat([p.trader_id for p in params.agents])
    S = env.wcfg.n_orders
    n_agg = int(tids.numel())
    plan = bkern.launch_plan(S, n_agg, DEV)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    waves = -(-MESH_ENVS // (plan["warps_per_sm"] * sms))
    print(f"  kernel 1 launch plan at S={S}, {n_agg} traders: "
          f"{plan['registers']} registers a thread, {plan['spill_bytes']} "
          f"spill bytes, {plan['dynamic_smem']} B of dynamic shared memory "
          f"a block, {plan['warps_per_sm']} warps an SM on {sms} SMs: "
          f"{waves} waves at E={MESH_ENVS}", flush=True)

    def same(cfg, msgs, book, prev, u, label):
        got = bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK, u)
        want = bkern.process_step_aggs_reference(cfg, msgs, book, tids,
                                                 prev, TICK, u)
        pairs = [(got[0].data, want[0].data), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1]), (got[2][0], want[2][0]),
                 (got[2][1], want[2][1])]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"kernel 1 != plain at M={M_MESH}, "
                                 f"{n_agg} traders: {label}")

    from vit_marl_tpu_torch.lob.book import BookState
    cases = {}
    for mode in range(4):
        book, msgs, prev = make_case(MESH_ENVS, M_MESH, S, SEED + 60 + mode,
                                     tids=tuple(tids.tolist()))
        u = np.random.default_rng(SEED + mode).random(
            (M_MESH, MESH_ENVS), dtype=np.float32)
        case = (torch.from_numpy(msgs).to(DEV),
                BookState(torch.from_numpy(book).to(DEV)),
                torch.from_numpy(prev).to(DEV), torch.from_numpy(u).to(DEV))
        cases[mode] = case
        same(EngineConfig(n_orders=S, cancel_mode=mode), *case,
             f"seeded streams, cancel mode {mode}")
    acts = random_actions(torch, env, MESH_ENVS, gen)
    draws = env.draw_step(MESH_ENVS, gen)
    combined, _ = env._build_messages(state, env._actions(acts), params,
                                      draws.shuffle, draws.agents)
    if combined.shape[1] != M_MESH:
        raise AssertionError(f"mesh world: M={combined.shape[1]}")
    prev = torch.stack([state.world.best_asks[:, -1, 0],
                        state.world.best_bids[:, -1, 0]], 1)
    world_case = (combined, state.world.books, prev, draws.uniforms)
    same(env.wcfg, *world_case, "the world's stream")
    mode = int(env.wcfg.cancel_mode)
    cfg = EngineConfig(n_orders=S, cancel_mode=mode)
    msgs, book, prev, u = cases[mode]
    ms, ms_min = time_launches(lambda: bkern.process_step_aggs(
        cfg, msgs, book, tids, prev, TICK, u))
    torch.cuda.synchronize()
    tp = time.perf_counter()
    bkern.process_step_aggs_reference(cfg, msgs, book, tids, prev, TICK, u)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tp) * 1e3
    nbytes = scan_bytes(MESH_ENVS, M_MESH, S, n_agg)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  kernel 1 at M={M_MESH}, E={MESH_ENVS}, {n_agg} traders: "
          f"bit-equal to plain in cancel modes 0-3 and on the world's "
          f"stream; {ms:.4f} ms per launch (min {ms_min:.4f}, cancel mode "
          f"{mode}); plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s) [{smi}]", flush=True)
    return dict(ms_m220=ms, plain_ms_m220=plain_ms, bound_ms_m220=bound_ms,
                bit_equal_m220=True, waves_m220=waves,
                registers_m220=plan["registers"],
                dynamic_smem_m220=plan["dynamic_smem"])


def mesh_phase(torch, count, bkern, make_train, smi):
    """``configs/mesh_ippo_2player.yaml`` as one rank of its published
    8-way run: a 1-rank NCCL group, NUM_ENVS=MESH_ENVS (its 32,768 / 8),
    10 + 10 agents, M=220; one update with finite losses and kernel 1's
    launches exact; then :func:`mesh_scan_checks` on the world."""
    import datetime

    import torch.distributed as dist
    from vit_marl_tpu_torch.parallel.distributed import DataGroup, free_port

    ma, tc = config_with(MESH_CONFIG, [f"NUM_ENVS={MESH_ENVS}",
                                       "MESH_SHAPE=[1]",
                                       "LOG_BACKEND=none",
                                       "UPDATE_EPOCHS=1"])
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"group backend {dist.get_backend()}")
        group = DataGroup.current()
        _, _, train, _ = train_once(
            torch, count, make_train, ma, tc,
            {"book_scan": rollout_steps(tc, 1)},
            f"mesh_ippo_2player.yaml, rank 0 of a 1-rank NCCL group, "
            f"{ma.n_agents_per_type} agents", smi, group=group)
        if train.group.group is None or train.env.num_msgs_per_step != M_MESH:
            raise AssertionError("the mesh run took no group, or M != 220")
    finally:
        dist.destroy_process_group()
    env = train.env
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = env.default_params
    _, state = env.reset(env.draw_reset(MESH_ENVS, gen), params)
    for _ in range(2):
        state = env.step_vec(state, random_actions(torch, env, MESH_ENVS,
                                                   gen), params,
                             generator=gen)[1]
    return mesh_scan_checks(torch, bkern, env, state, params, gen, smi)


def slice11_phase(torch, attn, bkern, blk, make_train, smi):
    """Phase 17: the networks, layouts, rollout and data parallelism of
    the port's eleventh slice, each path driven once with every count
    set to 0 just before it, each update with one PPO epoch (the cut
    that makes room for phases 19-20).  Returns the counts and the
    kernel-1 numbers at M=220."""
    from vit_marl_tpu_torch.env import spaces
    from vit_marl_tpu_torch.models.cnn import CNNActorCriticRNN
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    count = counters(attn, bkern, blk)
    out = {}
    ma, tc = config_with(VISION_CONFIG, ["NETWORK=[gru, cnn_gru]",
                                         "LOG_BACKEND=none",
                                         "UPDATE_EPOCHS=1"])
    _, out["cnn_gru"], _, nets = train_once(
        torch, count, make_train, ma, tc, {"book_scan": rollout_steps(tc, 1)},
        "ippo_vision_dual_ppo.yaml on NETWORK=[gru, cnn_gru]", smi)
    if not isinstance(nets[1], CNNActorCriticRNN):
        raise AssertionError("NETWORK=[gru, cnn_gru] built no CNN")
    ma, tc = config_with(CONFIG, [
        "AGENT_CONFIGS.EXECUTION.ACTION_SPACE=fixed_prices",
        "AGENT_CONFIGS.EXECUTION.N_ACTIONS=4", f"NUM_ENVS={BOX_ENVS}",
        "LOG_BACKEND=none", "UPDATE_EPOCHS=1"])
    m, out["gru_box"], train, nets = train_once(
        torch, count, make_train, ma, tc, {"book_scan": rollout_steps(tc, 1)},
        "ippo_2player.yaml, execution fixed_prices (a Box) on gru", smi)
    if not isinstance(train.env.action_spaces[1], spaces.Box) or \
            not nets[1].continuous or "EXE/action_std" not in m:
        raise AssertionError("the gru update took no Box action")
    out["layouts"] = layouts_check(torch, count, smi)
    ma, tc = config_with(SIMPLEST_CONFIG, [
        f"AGENT_CONFIGS.EXECUTION.VISION_LEVELS={LONG_LEVELS}",
        "LOG_BACKEND=none", "UPDATE_EPOCHS=1"])
    depth = VIT_PRESETS[tc.vit_preset].depth
    _, out["long"], _, _ = train_once(
        torch, count, make_train, ma, tc,
        vision_launches(tc, depth, 1, "long"),
        f"ippo_vision_simplest.yaml, VISION_LEVELS={LONG_LEVELS} "
        f"({LONG_LEVELS + 1} tokens)", smi)
    ma, tc = config_with(VISION_CONFIG, ["ROLLOUT_MODE=pipeline",
                                         "LOG_BACKEND=none",
                                         "UPDATE_EPOCHS=1"])
    _, out["pipeline"], _, _ = train_once(
        torch, count, make_train, ma, tc,
        vision_launches(tc, depth, 1, halves=2),
        "ippo_vision_dual_ppo.yaml, ROLLOUT_MODE=pipeline", smi)
    out["bench"] = pipeline_bench(torch, count, smi)
    out["m220"] = mesh_phase(torch, count, bkern, make_train, smi)
    return out


# phase 18: kernels 5 and 7 past 32 tokens (their route through a qkv
# buffer and long_attention.cuh), checked at every N of LONG_TOKENS on
# LONG_CHECK_B images and timed at N=41 on LONG_TIME_B images; the scan
# (a CUDA graph of the step) against the loop, in turns, at the 2-player
# and vision shapes
LONG_TOKENS = (33, 41, 51, 64, 65, 128, 129, 257)
LONG_CHECK_B = 64
LONG_TIME_B = (1024, 8192)
LONG_KERNELS = ("fused_block_full", "fused_ln_qkv_attn")
SCAN_TURNS = ("loop", "scan", "scan", "loop", "loop", "scan")


def long_block_phase(torch, blk, smi):
    """Kernels 5 and 7 past 32 tokens at ViT-Small's widths (W=384, 6
    heads of 64, hidden 1,536): against their plain versions at every N
    of LONG_TOKENS in bf16 and float32 within ``block_tol``, each call
    counted once on its dtype's route and not as an LN+QKV or proj+MLP
    call; then at N=41 and LONG_TIME_B images each dtype's output within
    ``block_tol`` of its plain version, and its time beside its bound,
    its plain version and the port's unfused PyTorch sequence.  Returns
    {name: entries for the summary line}."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    W, H, hidden = ATT_W, ATT_H, MLP_RATIO * ATT_W
    routes0 = block_route_counts(blk)
    inner0 = (blk.fused_ln_qkv.launches, blk.fused_proj_mlp.launches)
    errs = {(k, d): 0.0 for k in LONG_KERNELS for d in ("bf16", "f32")}
    params = {dt: block_params(gen, dt, W, hidden)
              for dt in (torch.bfloat16, torch.float32)}
    for dt, p in params.items():
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        for N in LONG_TOKENS:
            x = torch.randn((LONG_CHECK_B * N, W), generator=gen,
                            device=dev).to(dt)
            for name in LONG_KERNELS:
                kern, plain, _ = fused_calls(torch, blk, name, x, None, p, N,
                                             H)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                tol = block_tol(name, want)
                torch.testing.assert_close(
                    got, want, **tol,
                    msg=lambda m: f"{name} N={N} {dname}: {m}")
                err = float((got.float() - want.float()).abs().max())
                errs[name, dname] = max(errs[name, dname], err)
        print(f"  kernels 5 and 7 past 32 tokens, {dname}, B={LONG_CHECK_B}"
              f", N in {list(LONG_TOKENS)}: within block_tol of plain; max "
              f"abs err " + ", ".join(f"{k} {errs[k, dname]:.4g}"
                                      for k in LONG_KERNELS), flush=True)
    routes = {k: v - routes0[k] for k, v in block_route_counts(blk).items()}
    want = {f"{k}_{r}": (len(LONG_TOKENS) if k in LONG_KERNELS
                         and r != "composed" else 0)
            for k in TC_KERNELS for r in BLOCK_ROUTES}
    inner = (blk.fused_ln_qkv.launches - inner0[0],
             blk.fused_proj_mlp.launches - inner0[1])
    if routes != want or inner != (0, 0):
        raise AssertionError(f"past 32 tokens: launches by route {routes}, "
                             f"want {want}; LN+QKV and proj+MLP {inner}")
    rows = {k: {} for k in LONG_KERNELS}
    N = 41
    for dt, p in params.items():
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        reps = {} if dt == torch.bfloat16 else dict(batches=3, per_batch=3,
                                                   warm=1)
        for B in LONG_TIME_B:
            x = torch.randn((B * N, W), generator=gen, device=dev).to(dt)
            for name in LONG_KERNELS:
                kern, plain, seq = fused_calls(torch, blk, name, x, None, p,
                                               N, H)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                tol = block_tol(name, want)
                torch.testing.assert_close(
                    got, want, **tol,
                    msg=lambda m: f"{name} N={N} B={B} {dname}: {m}")
                err = float((got.float() - want.float()).abs().max())
                errs[name, dname] = max(errs[name, dname], err)
                del got, want
                ms, ms_min = time_launches(kern, **reps)
                plain_ms, _ = time_launches(plain, batches=3, per_batch=2,
                                            warm=1)
                seq_ms, _ = time_launches(seq, **reps)
                cost = block_cost(name, B, N, W, hidden, dt.itemsize)
                bnd, by = block_bound(*cost, "bfloat16" if dname == "bf16"
                                      else "float32")
                rows[name][f"{dname}_{B}"] = dict(
                    ms=ms, plain_ms=plain_ms, unfused_ms=seq_ms, bound_ms=bnd,
                    bound_by=by)
                print(f"  {name} N={N} B={B} {dname}: within block_tol of "
                      f"plain; {ms:.4f} ms a call "
                      f"(min {ms_min:.4f}; three launches: LN+QKV, the "
                      f"attention, {'proj+MLP' if 'full' in name else '-'}"
                      f"); bound {bnd:.4f} ms by {by} ({cost[0] / 1e6:.1f} "
                      f"MB, {cost[1] / 1e9:.1f} GFLOP products + "
                      f"{cost[2] / 1e9:.2f} GFLOP attention); plain "
                      f"{plain_ms:.3f} ms; unfused {seq_ms:.4f} ms [{smi}]",
                      flush=True)
            del x
    for name in LONG_KERNELS:
        rows[name].update(max_abs_err_bf16=errs[name, "bf16"],
                          max_abs_err_f32=errs[name, "f32"])
    return rows


def long_training_phase(torch, count, blk, make_train, smi):
    """One update of ``ippo_vision_simplest.yaml`` at VISION_LEVELS=40
    (41 tokens) under ``VIT_FUSED_BLOCK_FULL`` and under
    ``VIT_ATTN_LN_FOLD``, one PPO epoch (the config's 4 take 33 s of
    float32 recompute a mode): losses finite, every forward on the kernel
    (bf16: the wgmma route), and no attention backward kernel past 32
    tokens (``attn_ln_fold`` differentiates the XLA-form attention
    there, as the JAX package does); then the rollout alone in each mode
    under the profiler (:func:`traced_rollouts`), the graph's launches of
    LN+QKV's kernel, the long attention and proj+MLP's kernel counted.
    Returns {mode: (counts, traced rollouts)}."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    out = {}
    for mode, flag in (("fused_block_full", "VIT_FUSED_BLOCK_FULL"),
                       ("attn_ln_fold", "VIT_ATTN_LN_FOLD")):
        ma, tc = config_with(SIMPLEST_CONFIG, [
            f"AGENT_CONFIGS.EXECUTION.VISION_LEVELS={LONG_LEVELS}",
            f"{flag}=true", "UPDATE_EPOCHS=1", "LOG_BACKEND=none"])
        depth = VIT_PRESETS[tc.vit_preset].depth
        want = vision_launches(tc, depth, 1, mode)
        want.pop("short_attention_bwd", None)
        r0 = block_route_counts(blk)
        label = (f"ippo_vision_simplest.yaml, VISION_LEVELS={LONG_LEVELS} "
                 f"({LONG_LEVELS + 1} tokens), {mode}")
        _, got, train, _ = train_once(torch, count, make_train, ma, tc, want,
                                      label, smi)
        kernel = next(k for k, (_, m) in BLOCK_KERNELS.items() if m == mode)
        routes = {k: v - r0[k] for k, v in block_route_counts(blk).items()
                  if v - r0[k]}
        if routes != {f"{kernel}_wgmma": want[kernel]}:
            raise AssertionError(f"{mode} at 41 tokens: launches by route "
                                 f"{routes}")
        out[mode] = (got, traced_rollouts(
            torch, count, train.env, tc, label,
            {"book_scan": 1, kernel: depth}, LONG_LEVELS + 1, smi))
    return out


# the hand-written kernels in a profiler trace: a piece of the kernel's
# name (its mangled form holds it too), and the family of launch counters
# whose calls launch it
KERNEL_FAMILIES = (("book_scan_kernel", "book_scan"),
                   ("attn_fwd_", "short_attention_fwd"),
                   ("attn_bwd_", "short_attention_bwd"),
                   ("long_attn", "fused_block"),
                   ("ln_qkv_attn_kernel", "fused_block"),
                   ("qkv_kernel", "fused_block"),
                   ("tc_kernel", "fused_block"),
                   ("proj_mlp_kernel", "fused_block"),
                   ("full_block_kernel", "fused_block"))


# phase 18 traces rollouts of at most TRACE_STEPS steps (the turns and
# the update keep NUM_STEPS): a vision trace of 128 steps held about
# 216,700 kernel records, and the traces' export and reading took much of
# the script's time
TRACE_STEPS = 16
# a profiler trace of a graph's replays drops a few kernel records (the
# same vision rollout traced four times held 216,237-216,705 kernels,
# NVIDIA H100 80GB HBM3): a family's traced launches may fall short of
# the launches by at most TRACE_LOSS of them, or TRACE_FLOOR for every 128
# steps traced (2 of 128 book scans), and never exceed them
TRACE_LOSS, TRACE_FLOOR = 0.02, 2


def kernel_family(name):
    return next((f for piece, f in KERNEL_FAMILIES if piece in name), None)


def graph_nodes(graph):
    """The hand-written kernels' nodes in a captured CUDA graph, by family,
    from its DOT dump (``CUDAGraph.debug_dump``; the scan keeps its
    graph, ``keep_graph=True``): each kernel node's label names its
    function once."""
    import warnings

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as f:
            txt = f.read()
    out = {}
    for piece, fam in KERNEL_FAMILIES:
        if txt.count(piece):
            out[fam] = out.get(fam, 0) + txt.count(piece)
    return out


def check_traced(label, traced_, launches, steps):
    """Hold a trace of ``steps`` steps' launches by family against the
    launches made."""
    short = {f: launches.get(f, 0) - traced_.get(f, 0)
             for f in set(launches) | set(traced_)}
    floor = TRACE_FLOOR * steps / 128
    if any(v < 0 or v > max(floor, TRACE_LOSS * launches.get(f, 0))
           for f, v in short.items()):
        raise AssertionError(f"{label}: the trace holds {traced_} launches "
                             f"of the hand-written kernels, want {launches}")


def family_launches(got, tokens):
    """The launches of each kernel family that the wrappers' counts
    ``got`` stand for: a fused-block call past 32 tokens is three
    launches (kernel 7: LN+QKV, the long attention, proj+MLP) or two
    (kernel 5), every other call one."""
    long = tokens > 32
    per_call = {"fused_ln_qkv": 1, "fused_proj_mlp": 1,
                "fused_block_full": 3 if long else 1,
                "fused_ln_qkv_attn": 2 if long else 1}
    out = {"book_scan": got["book_scan"] + got["book_scan_records"],
           "short_attention_fwd": got["short_attention_fwd"],
           "short_attention_bwd": got["short_attention_bwd"],
           "fused_block": sum(got[k] * n for k, n in per_call.items())}
    return {k: v for k, v in out.items() if v}


def update0_both(torch, count, make_train, ma, tc, env, want_fn, label,
                 smi):
    """Update 0 of one config under ``ROLLOUT_MODE=loop`` and ``scan`` on
    one world: the metrics bit-equal, each mode's wrapper launches
    exactly ``want_fn(its config)`` (the scan's rollout launches through
    the wrappers only in its warm-up step), the peak memory of each.
    Returns the numbers by mode."""
    res = {}
    for mode in ("loop", "scan"):
        tcm = dataclasses.replace(tc, rollout_mode=mode)
        train = make_train(ma, tcm, env=env)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, got, wall = drive(torch, count,
                               lambda: train(tc.seed, n_updates=1))
        expect(got, want_fn(tcm), f"{label}, {mode}")
        m = out["metrics"][0]
        res[mode] = dict(metrics={k: v for k, v in m.items()
                                  if k not in ("rollout_s", "update_s")},
                         rollout_s=m["rollout_s"], update_s=m["update_s"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         wall=wall, launches={k: v for k, v in got.items()
                                              if v})
        del train, out
    a, b = res["scan"]["metrics"], res["loop"]["metrics"]
    differ = sorted(k for k in a if a[k] != b.get(k))
    if differ or set(a) != set(b):
        raise AssertionError(f"{label}: update 0 under scan differs from "
                             f"loop in {differ}")
    s, l_ = res["scan"], res["loop"]
    print(f"  {label}, update 0: scan bit-equal to loop in all {len(a)} "
          f"metrics; wrapper launches, scan {s['launches']} (the warm-up "
          f"step's and the update's), loop {l_['launches']}; rollout "
          f"{s['rollout_s']:.3f} s (with the scan's set-up) against "
          f"{l_['rollout_s']:.3f} s; PPO {s['update_s']:.3f} / "
          f"{l_['update_s']:.3f} s; peak memory {s['peak_gib']:.2f} / "
          f"{l_['peak_gib']:.2f} GiB [{smi}]", flush=True)
    return res


def traced_rollouts(torch, count, env, tc, label, per_step, tokens, smi,
                    turns=()):
    """The rollout alone (``rl/scan.py`` against ``rollout_loop``, one
    world, one set of networks, each run from the carry the last one
    left), after the scan's set-up (warm-up, capture, instantiation,
    timed apart).  Timed in ``turns`` (modes in order, e.g. SCAN_TURNS).
    Checks what the graph launches: its kernel nodes by family
    (:func:`graph_nodes`) equal what the loop's wrappers launch a step
    (``per_step``, counter: launches a step); every run of the scan
    replays its one graph NUM_STEPS times (``StepGraph.replays``, counted
    where it replays); one rollout of each mode under ``torch.profiler``,
    of min(TRACE_STEPS, NUM_STEPS) steps (the scan's the first steps of
    the same graph), every count set to 0 just before it: the loop's
    wrappers launch exactly ``per_step`` a step, the scan replays its
    graph once a step and launches no wrapper, and each trace holds the
    launches of each family that its run made, within TRACE_LOSS.  The
    card's busy share of each kernel window.  Returns the numbers."""
    from torch_pipeline_overlap import traced, union
    from vit_marl_tpu_torch.rl import ppo as tppo
    from vit_marl_tpu_torch.rl.scan import ScanRollout

    E, T = tc.num_envs, tc.num_steps
    Tt = min(TRACE_STEPS, T)
    torch.manual_seed(tc.seed)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(tc.seed)
    params = env.default_params
    obs, state = env.reset(env.draw_reset(E, gen), params)
    actors = [n * E for n in env.n_per_type]
    carry = tppo.Carry(state, obs, [torch.zeros(n, dtype=torch.bool,
                                                device=DEV) for n in actors],
                       [torch.zeros(n, tc.hidden_size, device=DEV)
                        for n in actors])
    scan = ScanRollout(env.step_vec, nets, params, T, E, env.n_per_type,
                       gen, gen, tc.log_env_info, DEV)
    runs = []                   # the graph's replays in each full run

    def rollout(mode, steps=T):
        nonlocal carry
        with torch.no_grad():
            if mode == "scan":
                r0 = scan.replays
                _, _, c = scan.run(carry, steps=steps)
                if steps == T:
                    runs.append(scan.replays - r0)
            else:
                _, _, c = tppo.rollout_loop(env.step_vec, nets, carry, params,
                                            steps, E, env.n_per_type, gen,
                                            gen, tc.log_env_info)
        carry = c

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout("scan")
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    full = {k: 0 for k in count}
    full.update(per_step)
    nodes = graph_nodes(scan.graph)
    if nodes != family_launches(full, tokens):
        raise AssertionError(f"{label}: the graph holds {nodes} nodes of the "
                             f"hand-written kernels; a loop step launches "
                             f"{family_launches(full, tokens)}")
    secs = {"loop": [], "scan": []}
    for mode in turns or ():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(mode)
        torch.cuda.synchronize()
        secs[mode].append(time.perf_counter() - t0)
    busy, trace = {}, {}
    if runs != [T] * len(runs):
        raise AssertionError(f"{label}: the scan's runs replayed its graph "
                             f"{runs} times, want {T} each")
    for mode in ("loop", "scan"):
        r0 = scan.replays
        (by_stream, host, names), got, _ = drive(
            torch, count, lambda: traced(torch, lambda: rollout(mode, Tt)))
        ivs = [iv for v in by_stream.values() for iv in v]
        window = (max(b for _, b in ivs) - min(x for x, _ in ivs)) if ivs \
            else 0.0
        busy[mode] = dict(share=union(ivs) / window if window else None,
                          kernels=len(ivs), window_s=window / 1e6,
                          host_s=host)
        fams = {}
        for n, c in names.items():
            if kernel_family(n):
                fams[kernel_family(n)] = fams.get(kernel_family(n), 0) + c
        trace[mode] = dict(traced=fams, replays=scan.replays - r0,
                           wrappers={k: v for k, v in got.items() if v})
    lw = trace["loop"]["wrappers"]
    want = {k: n * Tt for k, n in per_step.items()}
    if lw != want:
        raise AssertionError(f"{label}: the loop's rollout launched "
                             f"{lw} through the wrappers, want {want}")
    if trace["scan"]["wrappers"] or trace["scan"]["replays"] != Tt:
        raise AssertionError(
            f"{label}: the scan launched its graph "
            f"{trace['scan']['replays']} times, want {Tt}, and through the "
            f"wrappers {trace['scan']['wrappers']}, want none")
    full.update(lw)
    trace["loop"]["launches"] = family_launches(full, tokens)
    trace["scan"]["launches"] = {f: n * Tt for f, n in nodes.items()}
    for mode, tr in trace.items():
        check_traced(f"{label}, {mode}", tr["traced"], tr["launches"], Tt)
    rates = {m: [E * T / x for x in v] for m, v in secs.items()}
    timed = (f"in turns {list(turns)}: scan "
             + ", ".join(f"{x:.4f}" for x in secs["scan"]) + " s ("
             + ", ".join(f"{r:.0f}" for r in rates["scan"])
             + " env-steps/s), loop "
             + ", ".join(f"{x:.4f}" for x in secs["loop"]) + " s ("
             + ", ".join(f"{r:.0f}" for r in rates["loop"])
             + " env-steps/s); ") if turns else ""
    print(f"  {label}, the rollout alone ({E} envs x {T} steps), {timed}"
          f"the scan's first run {first:.3f} s (warm-up "
          f"{scan.warmup_s:.3f} s, capture {scan.capture_s:.3f} s, "
          f"instantiate {scan.instantiate_s:.3f} s); the graph holds "
          f"{nodes} hand-written kernel nodes (its DOT dump), replayed "
          f"{runs} times in the scan's runs; under the profiler, the "
          f"first {Tt} steps: the graph launched "
          f"{trace['scan']['replays']} times, no wrapper, the scan's trace "
          f"holds {trace['scan']['traced']}, the loop's "
          f"{trace['loop']['traced']} (its wrappers {lw}); "
          + "; ".join(f"{m}: {b['kernels']} kernels, busy "
                      f"{b['share'] and round(b['share'], 4)} of a "
                      f"{b['window_s']:.4f} s kernel window, host "
                      f"{b['host_s']:.3f} s" for m, b in busy.items())
          + f" [{smi}]", flush=True)
    return dict(rollout_s=secs, env_steps_per_s=rates, busy=busy,
                first_run_s=first, warmup_s=scan.warmup_s,
                capture_s=scan.capture_s, instantiate_s=scan.instantiate_s,
                graph_nodes=nodes, replays=trace["scan"]["replays"],
                replays_per_run=runs,
                graph_launches={f: n * runs[0] for f, n in nodes.items()},
                traced_steps=Tt,
                graph_launches_traced=trace["scan"]["traced"])


def scan_turns(torch, count, make_train, path, sets, label, want_fn,
               per_step, smi, turns=SCAN_TURNS, traces=True, tokens=11,
               env=None):
    """``ROLLOUT_MODE=scan`` against ``loop`` on one config, with one PPO
    epoch (the config's epochs are the same code again):
    :func:`update0_both`, then (with ``traces``) :func:`traced_rollouts`
    on the same world (``env``: one built for the config already).
    Returns the numbers, and the world in ``env``."""
    from vit_marl_tpu_torch.env.world import WorldEnv

    ma, tc = config_with(path, sets + ["LOG_BACKEND=none",
                                       "UPDATE_EPOCHS=1"])
    env = env or WorldEnv(ma, device=DEV)
    out = dict(update0=update0_both(torch, count, make_train, ma, tc, env,
                                    want_fn, label, smi), env=env)
    if traces:
        out.update(traced_rollouts(torch, count, env, tc, label, per_step,
                                   tokens, smi, turns))
    return out


def bench_scan_phase(torch, count, smi):
    """``python -m vit_marl_tpu_torch.bench`` in-process at 4,096 envs (10
    steps x 2 reps) with GRU and ViT-Small policies, ``--mode loop`` then
    ``--mode scan``: each prints its ``env_steps_per_sec_per_chip`` line
    (reprinted here), the scan's with a value > 0, the wrappers'
    launches of both exact.  Returns the rates."""
    from vit_marl_tpu_torch import bench

    rates = {}
    for policy, depth in (("gru", 0), ("vit-small", 12)):
        for mode in ("loop", "scan"):
            argv = BENCH_ARGS + ["--policy", policy, "--mode", mode]
            args = bench.parse_args(argv)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out, got, wall = drive(torch, count,
                                       lambda: bench.main(argv))
            # the world's window table is one book scan; the loop runs one
            # untimed step and the timed ones, the scan its warm-up step
            # through the wrappers (its replays launch without them)
            steps = 1 + args.steps * args.reps if mode == "loop" else 1
            want = {"book_scan": 1 + steps}
            if depth:
                want["short_attention_fwd"] = depth * steps
            expect(got, want, f"bench {policy} {mode}")
            line = buf.getvalue().strip().splitlines()[-1]
            if json.loads(line)["metric"] != \
                    f"env_steps_per_sec_per_chip[{policy},{mode}]" or \
                    not out["value"] > 0:
                raise AssertionError(f"bench {policy} {mode}: {line}")
            rates[f"{policy},{mode}"] = out["value"]
            print(f"  bench --policy {policy} --mode {mode}: {line} "
                  f"({wall:.2f} s with the world's set-up) [{smi}]",
                  flush=True)
    return rates


def slice12_phase(torch, attn, bkern, blk, make_train, smi):
    """Phase 18: kernels 5 and 7 past 32 tokens, training at 41 tokens in
    both fused modes, the scan against the loop (the 2-player, debug-mode,
    vision and ``cnn_gru`` configs), and the bench's ``--mode scan``;
    each path driven with every count set to 0 just before it."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    count = counters(attn, bkern, blk)
    out = {"long": long_block_phase(torch, blk, smi)}
    out["long_training"] = long_training_phase(torch, count, blk, make_train,
                                               smi)
    _, tc = config_with(CONFIG, [])
    out["scan_2player"] = scan_turns(
        torch, count, make_train, CONFIG, [],
        f"ippo_2player.yaml ({tc.num_envs} envs)",
        lambda t: {"book_scan": rollout_steps(t, 1)}, {"book_scan": 1}, smi,
        turns=SCAN_TURNS[:4])
    out["scan_debug"] = scan_turns(
        torch, count, make_train, CONFIG, ["WORLD.DEBUG_MODE=true"],
        f"ippo_2player.yaml, DEBUG_MODE ({tc.num_envs} envs)",
        lambda t: {"book_scan_records": rollout_steps(t, 1)},
        {"book_scan_records": 1}, smi, turns=())
    _, tc = config_with(VISION_CONFIG, [])
    depth = VIT_PRESETS[tc.vit_preset].depth
    out["scan_vision"] = scan_turns(
        torch, count, make_train, VISION_CONFIG, [],
        f"ippo_vision_dual_ppo.yaml ({tc.num_envs} envs)",
        lambda t: vision_launches(t, depth, 1),
        {"book_scan": 1, "short_attention_fwd": depth}, smi,
        turns=SCAN_TURNS[:4])
    # cuDNN's deterministic algorithms for this check: without them update
    # 0 of cnn_gru differs between two runs of the loop itself (in
    # EXE/actor_loss and EXE/approx_kl; tools/torch_scan_repeat.py)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out["scan_cnn_gru"] = scan_turns(
            torch, count, make_train, VISION_CONFIG,
            ["NETWORK=[gru, cnn_gru]"],
            f"ippo_vision_dual_ppo.yaml on NETWORK=[gru, cnn_gru] "
            f"({tc.num_envs} envs, cudnn.deterministic)",
            lambda t: {"book_scan": rollout_steps(t, 1)}, {"book_scan": 1},
            smi, traces=False, env=out["scan_vision"]["env"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["bench"] = bench_scan_phase(torch, count, smi)
    for k in ("scan_2player", "scan_debug", "scan_vision", "scan_cnn_gru"):
        out[k].pop("env")
    return out


# ---------------------------------------------------------------------------
# phase 19: greedy eval and evaluate.py as CUDA graphs
# ---------------------------------------------------------------------------

# the eval alone: pairs from one generator state, graph and host loop in
# turns (loop, graph, graph, loop)
EVAL_TURNS = (("loop", "graph"), ("graph", "loop"))
# the greedy eval's rate before it had a graph (this script's evaluation
# phase, NVIDIA H100 80GB HBM3, 700 W): the 2-player eval at 4,096 envs x
# 32 steps, host-issued
EARLIER_EVAL_RATE = 232_669
# evaluate.py on the baseline world, after the checkpoint's run (scan)
EVALUATE_TURNS = ("loop", "scan")


def eval_turns(torch, count, env, nets, tc, label, per_step, smi):
    """The greedy eval alone on one trainer's eval world and networks:
    ``rl/ppo.py::EvalRollout`` (one graph of the step) against
    ``eval_rollout_loop`` in :data:`EVAL_TURNS`, each pair from one
    generator state and bit-equal in every metric; the wrappers launch
    ``per_step`` once (the graph's warm-up, its first run) and none on
    later replays, ``per_step`` a step in the loop.  Returns the seconds
    of each run by kind and the set-up."""
    from vit_marl_tpu_torch.rl import ppo

    n_ev = tc.eval_envs or tc.num_envs
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    graph = ppo.EvalRollout(env, nets, n_ev, tc.eval_steps, tc.hidden_size,
                            tc.log_env_info, gen)

    def loop():
        return ppo.eval_rollout_loop(env, nets, n_ev, tc.eval_steps,
                                     tc.hidden_size, tc.log_env_info, gen)

    secs = {"graph": [], "loop": []}
    for pair in EVAL_TURNS:
        start, res = gen.get_state(), {}
        for how in pair:
            gen.set_state(start)
            first = how == "graph" and graph.graph is None
            res[how], got, wall = drive(
                torch, count, graph.run if how == "graph" else loop)
            want = {k: v * (tc.eval_steps if how == "loop" else int(first))
                    for k, v in per_step.items()}
            expect(got, want, f"{label}, eval {how}")
            secs[how].append(wall)
        differ = [k for k in res["loop"]
                  if not torch.equal(res["graph"][k], res["loop"][k])]
        if differ or list(res["graph"]) != list(res["loop"]):
            raise AssertionError(f"{label}: the eval graph differs from the "
                                 f"host-issued eval in {differ}")
    if graph.captures != int(DEV == "cuda"):
        raise AssertionError(f"{label}: {graph.captures} eval captures")
    steps = n_ev * tc.eval_steps
    print(f"  {label}, greedy eval alone ({n_ev} envs x {tc.eval_steps} "
          f"steps), in turns: " + ", ".join(
              f"{how} {secs[how][k]:.4f} s ({steps / secs[how][k]:.0f} "
              f"env-steps/s)" for how, k in _turn_index(EVAL_TURNS))
          + f"; the graph's first run holds its set-up (warm-up "
          f"{graph.warmup_s:.3f} s, capture {graph.capture_s:.3f} s, "
          f"instantiate {graph.instantiate_s:.3f} s); every pair "
          f"bit-equal in all {len(res['loop'])} metrics; the earlier "
          f"host-issued rate {EARLIER_EVAL_RATE} env-steps/s [{smi}]",
          flush=True)
    return dict(secs, setup=[graph.warmup_s, graph.capture_s,
                             graph.instantiate_s], steps=steps)


def _turn_index(turns):
    """(kind, its k-th run) of each run of ``turns`` in order."""
    seen = {}
    for pair in turns:
        for how in pair:
            yield how, seen.get(how, 0)
            seen[how] = seen.get(how, 0) + 1


def eval_training(torch, count, make_train, path, sets, label, want_fn,
                  smi, ckpt_dir=None):
    """One update of a config with ``EVAL_EVERY=1`` (the trainer's eval on
    its graph), launches exact (``want_fn(tc)``), the eval keys there;
    returns (the train function's output, its eval world, tc)."""
    from vit_marl_tpu_torch.env.world import WorldEnv

    ma, tc = config_with(path, sets + [
        "LOG_BACKEND=none", "EVAL_EVERY=1", f"EVAL_STEPS={EVAL_STEPS}",
        "UPDATE_EPOCHS=1"])
    if ckpt_dir:
        tc = dataclasses.replace(tc, checkpoint_dir=ckpt_dir)
    env = WorldEnv(ma, device=DEV)
    train = make_train(ma, tc, env=env)
    out, got, wall = drive(torch, count, lambda: train(tc.seed, n_updates=1))
    expect(got, want_fn(tc), f"{label} with eval")
    m = out["metrics"][0]
    for k in ("MM/eval_mean_reward", "EXE/eval_mean_reward",
              "eval_MM/action_pct_0", "eval_EXE/info_reward_mean",
              "eval_world/end_mid_price_mean"):
        if not np.isfinite(m.get(k, np.nan)):
            raise AssertionError(f"{label}: eval key {k} missing or "
                                 "not finite")
    n_eval = sum(1 for k in m if "eval" in k)
    print(f"  {label} with EVAL_EVERY=1, EVAL_STEPS={tc.eval_steps}, one "
          f"PPO epoch: 1 update in {wall:.2f} s (rollout "
          f"{m['rollout_s']:.3f} s, PPO {m['update_s']:.3f} s, then the "
          f"eval on its graph); {n_eval} eval keys, MM/eval_mean_reward "
          f"{m['MM/eval_mean_reward']:.5g}, EXE/eval_mean_reward "
          f"{m['EXE/eval_mean_reward']:.5g}; launches {got} [{smi}]",
          flush=True)
    return out, train.eval_env, tc


def evaluate_turns(torch, count, ckpt_dir, smi):
    """``vit_marl_tpu_torch/evaluate.py`` in process at E_MAIN envs x
    EVAL_LABEL_STEPS steps, every label a graph of its step: on the
    2-player checkpoint of :func:`eval_graph_phase` once, and on the
    AvSt/twap baseline world under ``ROLLOUT_MODE`` scan and loop in
    turns (:data:`EVALUATE_TURNS`), the summaries of the two modes
    equal; each label's seconds; launches exact (the window table and a
    label's warm-up step under the graph, every step under the loop)."""
    from vit_marl_tpu_torch import evaluate
    from vit_marl_tpu_torch.eval import combinations

    runs = [("2-player, checkpoint", "scan", [
        "--config", CONFIG, "--checkpoint-dir", ckpt_dir])]
    base = ["--config", CONFIG,
            "--set", "AGENT_CONFIGS.MarketMaking.ACTION_SPACE=AvSt",
            "--set", "AGENT_CONFIGS.Execution.ACTION_SPACE=twap"]
    runs += [("AvSt/twap baseline world", mode,
              base + ["--set", f"ROLLOUT_MODE={mode}"])
             for mode in EVALUATE_TURNS]
    out, summaries = {}, {}
    plain = {"rollout": combinations.rollout,
             "rollout_loop": combinations.rollout_loop}
    for label, mode, args in runs:
        secs = []

        def timed(fn):
            def run(*a, **k):
                t = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                return res
            return run
        for name, fn in plain.items():
            setattr(combinations, name, timed(fn))
        with tempfile.TemporaryDirectory() as d:
            try:
                argv = args + ["--num-envs", str(E_MAIN), "--num-steps",
                               str(EVAL_LABEL_STEPS), "--out-dir", d,
                               "--device", DEV]
                with contextlib.redirect_stdout(io.StringIO()):
                    res, got, wall = drive(torch, count,
                                           lambda: evaluate.main(argv))
            finally:
                for name, fn in plain.items():
                    setattr(combinations, name, fn)
            with open(os.path.join(d, "combinations.json")) as f:
                summary = json.load(f)
        per_label = 1 if mode == "scan" else EVAL_LABEL_STEPS
        expect(got, {"book_scan": 1 + 4 * per_label},
               f"evaluate.py, {label}, {mode}")
        if sorted(summary) != ["BB", "BL", "LB", "LL"] or not all(
                np.isfinite(r["mean_rewards"]).all()
                for r in summary.values()):
            raise AssertionError(f"evaluate.py, {label}: {summary}")
        if label in summaries and summaries[label] != summary:
            raise AssertionError(f"evaluate.py, {label}: {mode} gives "
                                 f"{summary}, the other mode "
                                 f"{summaries[label]}")
        summaries[label] = summary
        rates = ", ".join(
            f"{c} {s:.3f}s ({E_MAIN * EVAL_LABEL_STEPS / s:.0f} "
            f"env-steps/s, mean rewards "
            f"{[round(v, 4) for v in summary[c]['mean_rewards']]})"
            for c, s in zip(res, secs))
        print(f"  evaluate.py, {label}, ROLLOUT_MODE={mode}: {rates}; "
              f"{wall:.2f}s in all [{smi}]", flush=True)
        out.setdefault(f"{label}, {mode}", []).append(dict(zip(res, secs)))
    print(f"  evaluate.py, AvSt/twap baseline world: the summaries of "
          f"scan and loop equal in every label", flush=True)
    return out


def eval_graph_phase(torch, count, make_train, smi):
    """Phase 19: the trainer's greedy eval and ``evaluate.py`` on CUDA
    graphs of their steps.  ``ippo_2player.yaml`` at 4,096 envs and
    ``ippo_vision_dual_ppo.yaml`` at 1,024 envs, each one update with
    ``EVAL_EVERY=1`` (one PPO epoch: the cut that makes room), then the
    eval alone in turns (:func:`eval_turns`); ``evaluate.py``
    (:func:`evaluate_turns`).  Returns the numbers."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    out = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res, eval_env, tc = eval_training(
            torch, count, make_train, CONFIG, [], "ippo_2player.yaml",
            # the rollout's warm-up step, the eval's warm-up step (the
            # worlds' window tables are built before)
            lambda t: {"book_scan": rollout_steps(t, 1) + 1}, smi,
            ckpt_dir=ckpt_dir)
        out["2-player"] = eval_turns(
            torch, count, eval_env, res["networks"], tc,
            f"ippo_2player.yaml ({tc.num_envs} envs)", {"book_scan": 1},
            smi)
        out["evaluate"] = evaluate_turns(torch, count, ckpt_dir, smi)
    del res, eval_env
    _, tcv = config_with(VISION_CONFIG, [])
    depth = VIT_PRESETS[tcv.vit_preset].depth

    def vision_want(t):
        want = vision_launches(t, depth, 1)
        want["book_scan"] += 1
        want["short_attention_fwd"] += depth
        return want
    res, eval_env, tc = eval_training(
        torch, count, make_train, VISION_CONFIG, [],
        "ippo_vision_dual_ppo.yaml", vision_want, smi)
    out["vision"] = eval_turns(
        torch, count, eval_env, res["networks"], tc,
        f"ippo_vision_dual_ppo.yaml ({tc.num_envs} envs)",
        {"book_scan": 1, "short_attention_fwd": depth}, smi)
    return out


# ---------------------------------------------------------------------------
# phase 20: the model mesh axis on the card
# ---------------------------------------------------------------------------

# the vision config at ViT-Small width, cut in envs, steps and epochs
MODEL_AXIS_SETS = ["NUM_ENVS=256", "NUM_STEPS=32", "NUM_MINIBATCHES=2",
                   "UPDATE_EPOCHS=1", "LOG_BACKEND=none"]
MODEL_AXIS_MESH = ["MESH_SHAPE=[1,2]", "MESH_AXES=[data,model]"]


def learner_bytes(learners):
    """Bytes of the stored parameters (a split leaf's shard), of the Adam
    moments, and of the networks' whole weights (the gathered copy the
    compute reads), summed over agent types."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    stored = size(q for lr in learners for q in lr.opt_params)
    adam = size(t for lr in learners for st in lr.opt.state.values()
                for k, t in st.items() if k != "step")
    whole = size(p for lr in learners for p in lr.net.parameters())
    return {"params": stored, "adam": adam, "whole_weights": whole}


def _model_axis_run(torch, group, ref_path=None):
    """One update of the cut vision config: on a ``(1, 2)`` data x model
    mesh under ``group``, or in one process (``group`` None).  Returns
    its metrics, launches, bytes, peak memory, weight hashes and, with
    ``ref_path``, the largest difference from those weights."""
    import hashlib

    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import block_kernel as blk
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl.ppo import make_train

    ma, tc = config_with(VISION_CONFIG, MODEL_AXIS_SETS + (
        MODEL_AXIS_MESH if group is not None else []))
    count = counters(attn, bkern, blk)
    env = WorldEnv(ma, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, got, wall = drive(torch, count, lambda: make_train(
        ma, tc, env=env, group=group)(tc.seed, n_updates=1))
    # the run's own peak, above what the process held before it
    peak = torch.cuda.max_memory_allocated() - base
    nets = out["networks"]
    weights = [{k: v.detach().float().cpu() for k, v in
                net.state_dict().items()} for net in nets]
    diff = None
    if ref_path is not None:
        ref = torch.load(ref_path, weights_only=True)
        diff = max(float((w[k].double() - r[k].double()).abs().max())
                   for w, r in zip(weights, ref) for k in w)
    hashes = [hashlib.sha256(w[k].numpy().tobytes()).hexdigest()
              for w in weights for k in sorted(w)]
    metrics = {k: v for k, v in out["metrics"][0].items()
               if k not in ("rollout_s", "update_s")}
    secs = {k: out["metrics"][0][k] for k in ("rollout_s", "update_s")}
    g = out.get("learners")[0].group
    place = (None if g.model is None else
             (g.rank, g.world, g.model.rank, g.model.world))
    return dict(metrics=metrics, launches=got, wall=wall, peak=peak,
                secs=secs,
                bytes=learner_bytes(out["learners"]), diff=diff,
                hashes=hashes, place=place, lr=tc.lr,
                weights=weights if ref_path is None else None)


def model_axis_rank(group, ref_path):
    """A rank of :func:`model_axis_phase` (a child process on the card)."""
    import torch

    torch.cuda.set_device(0)
    return _model_axis_run(torch, group, ref_path)


def model_axis_phase(torch, make_train, smi):
    """Phase 20: one update of ``ippo_vision_dual_ppo.yaml`` at ViT-Small
    width (cut to :data:`MODEL_AXIS_SETS`) in one process, then on a
    ``(1, 2)`` data x model mesh as two processes on the card (a gloo
    group: NCCL puts no two ranks on one card; gloo carries the CUDA
    tensors of the collectives itself): each rank's launches exact, the
    two ranks' weights identical, their metrics within rtol 5e-4 / atol
    1e-5 of one process's and their weights within 3 x the learning
    rate; each rank's bytes of parameters and Adam state against one
    process's.  Returns the numbers."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS
    from vit_marl_tpu_torch.parallel.distributed import run_group

    one = _model_axis_run(torch, None)
    _, tc = config_with(VISION_CONFIG, MODEL_AXIS_SETS)
    depth = VIT_PRESETS[tc.vit_preset].depth
    want = vision_launches(tc, depth, 1)
    expect(one["launches"], want, "vision, one process")
    with tempfile.TemporaryDirectory() as d:
        ref_path = os.path.join(d, "weights.pt")
        torch.save(one.pop("weights"), ref_path)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ranks = run_group(model_axis_rank, 2, (ref_path,), deadline_s=600.0)
        wall = time.perf_counter() - t
    lr = max(tc.lr) if isinstance(tc.lr, (tuple, list)) else tc.lr
    for r, res in enumerate(ranks):
        expect(res["launches"], want, f"vision, model rank {r}")
        if tuple(res["place"]) != (0, 1, r, 2):
            raise AssertionError(f"rank {r} placed at {res['place']}")
        bad = [k for k, v in one["metrics"].items() if not np.isclose(
            res["metrics"][k], v, rtol=5e-4, atol=1e-5)]
        if bad or set(res["metrics"]) != set(one["metrics"]):
            raise AssertionError(f"model rank {r}: metrics {bad} differ "
                                 "from one process's")
        if not res["diff"] <= 3 * lr:
            raise AssertionError(f"model rank {r}: weights {res['diff']} "
                                 f"from one process's, over 3 x lr")
    if ranks[0]["hashes"] != ranks[1]["hashes"]:
        raise AssertionError("the two model ranks' weights differ")
    # the largest share of the tolerance a metric takes
    worst = max(abs(ranks[0]["metrics"][k] - v) / (1e-5 + 5e-4 * abs(v))
                for k, v in one["metrics"].items())
    ob = one["bytes"]
    print(f"  ippo_vision_dual_ppo.yaml (ViT-Small; "
          f"{', '.join(MODEL_AXIS_SETS[:4])}), "
          f"one update on a (1, 2) data x model mesh, two gloo processes "
          f"on the card: {len(one['metrics'])} metrics within rtol 5e-4 of "
          f"one process's (the largest takes {worst:.3g} of its tolerance), "
          f"weights within {max(r['diff'] for r in ranks):.3g} (3 x lr = "
          f"{3 * lr:.3g}), the two ranks' weights identical; launches a "
          f"rank {ranks[0]['launches']}; make_train and one update "
          f"{ranks[0]['wall']:.2f} / {ranks[1]['wall']:.2f} s on the two "
          f"ranks at once (rollout_s " + " / ".join(
              f"{r['secs']['rollout_s']:.3f}" for r in ranks)
          + ", update_s " + " / ".join(
              f"{r['secs']['update_s']:.3f}" for r in ranks)
          + f"; the ranks' first CUDA work in their processes) against "
          f"{one['wall']:.2f} s in one process (rollout_s "
          f"{one['secs']['rollout_s']:.3f}, update_s "
          f"{one['secs']['update_s']:.3f}); wall {wall:.1f} s for the two "
          f"processes (spawn, world build and update) [{smi}]", flush=True)
    for r, res in enumerate(ranks):
        b = res["bytes"]
        print(f"  model rank {r}: parameters stored {b['params']} B + Adam "
              f"state {b['adam']} B = {b['params'] + b['adam']} B "
              f"(whole weights for the compute {b['whole_weights']} B); "
              f"one process {ob['params']} + {ob['adam']} = "
              f"{ob['params'] + ob['adam']} B; the update's peak "
              f"allocation {res['peak'] / 2**20:.1f} MiB against one "
              f"process's {one['peak'] / 2**20:.1f} MiB [{smi}]",
              flush=True)
    return dict(one=one, ranks=ranks, wall=wall)


# ---------------------------------------------------------------------------
# phase 21: the order-book engine, the speed grid, the sweep, the PPO split
# ---------------------------------------------------------------------------

ENGINE_SHAPE = (256, 112, 128)  # E, M, S of the engine's checks
ENGINE_TIME_E = 4096
SPEED_GRID = dict(agents_grid=((1, 1), (10, 10)), n_data_msgs=(100,),
                  num_envs=4096, num_steps=20)
TOP_OPS = 10


def finite(metrics, label):
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")


def engine_checks(torch, smi):
    """(a) The engine on the card: in each cancel mode the ``OrderBook``
    facade (reset from L2 rows, a stream, its queries) and the engine's
    scans with saved best quotes and states, on corner streams, bit-equal
    to the same calls on the CPU; on the corners both JAX engines share,
    the engine against kernel 2 at ``rec_k = S`` and the log built from
    its records."""
    from torch_cases import (TIDS, add_sweeps, engine_against_records,
                             make_corner_case, make_l2_rows)
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob import OrderBook, engine
    from vit_marl_tpu_torch.lob.book import BookState

    E, M, S = ENGINE_SHAPE
    fills = {}
    for mode in range(4):
        cfg = EngineConfig(n_orders=S, n_trades=1024, cancel_mode=mode)
        book, msgs, _ = make_corner_case(E, M, S, seed=210 + mode, fill=0.7)
        u = torch.rand((M, E), generator=torch.Generator().manual_seed(mode))
        l2 = make_l2_rows(E, seed=mode)
        got = {}
        for dev in ("cpu", DEV):
            on = lambda x: torch.from_numpy(x).to(dev)      # noqa: E731
            ob = OrderBook(cfg, device=dev)
            st = ob.reset(l2)
            st = ob.process_orders_array(st, msgs, uniforms=u)
            log0 = torch.full((E, cfg.n_trades, 8), -1, dtype=torch.int32,
                              device=dev)
            b, log, quotes = engine.process_messages_save_bidask(
                cfg, on(msgs), BookState(on(book)), log0, M, u.to(dev))
            asks, bids, slog = engine.process_messages_save_states(
                cfg, on(msgs), BookState(on(book)), log0, 4, u.to(dev))
            got[dev] = ([st[0].data, st[1], ob.get_l2_state(st),
                         ob.get_vision_l2_state(st),
                         *ob.get_best_bid_and_ask(st),
                         ob.get_agent_trades(st, TIDS[0]),
                         b.data, log, *quotes, slog]
                        + [getattr(side, f) for side in (asks, bids)
                           for f in ("price", "quant", "oid", "tid",
                                     "time_s", "time_ns")])
        for i, (g, w) in enumerate(zip(got[DEV], got["cpu"])):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"engine, mode {mode}: output {i} on "
                                     "the card differs from the CPU")
        n_log = int((got["cpu"][7][..., 0] != -1).sum())
        sbook, smsgs, sprev = make_corner_case(E, M, S, seed=220 + mode,
                                               fill=0.7, shared=True,
                                               fresh_ids=True)
        smsgs = add_sweeps(smsgs, every=4, seed=mode, fresh_ids=True)
        n, most = engine_against_records(
            cfg, torch.from_numpy(smsgs).to(DEV),
            BookState(torch.from_numpy(sbook).to(DEV)),
            torch.from_numpy(sprev).to(DEV), u.to(DEV))
        fills[mode] = (n_log, n, most)
    print(f"  engine at E={E}, M={M}, S={S}, cancel modes 0-3: the "
          "OrderBook facade (reset, stream, queries) and the scans with "
          "saved quotes and states bit-equal on the card and the CPU "
          "(fills logged "
          + ", ".join(f"{v[0]}" for v in fills.values())
          + "); on shared corners with sweeps equal to kernel 2 at "
          f"rec_k={S} and its log (fills "
          + ", ".join(f"{v[1]} (most {v[2]} an env)" for v in fills.values())
          + f") [{smi}]", flush=True)
    return fills


def engine_timing(torch, bkern, smi):
    """The engine's ms a message and kernel 2's ms a step (rec_k = S, and
    the log built from its records) at E=4,096 on one stream, cancel mode
    1; the engine is a host loop of plain PyTorch, timed on the host clock
    between synchronisations (median of three calls after one)."""
    from torch_cases import make_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob import engine
    from vit_marl_tpu_torch.lob.book import BookState

    E, (_, M, S) = ENGINE_TIME_E, ENGINE_SHAPE
    cfg = EngineConfig(n_orders=S, n_trades=1024)
    book, msgs, prev = make_case(E, M, S, seed=230, fill=0.7)
    msgs = torch.from_numpy(msgs).to(DEV)
    prev = torch.from_numpy(prev).to(DEV)
    book = BookState(torch.from_numpy(book).to(DEV))
    log0 = torch.full((E, cfg.n_trades, 8), -1, dtype=torch.int32,
                      device=DEV)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.process_messages(cfg, msgs, book, log0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    eng_ms = float(np.median(walls[1:]))

    def k2():
        _, _, (rec, cnt) = bkern.process_step_records(cfg, msgs, book, prev,
                                                      S)
        return bkern.finalize_trade_log_from_records(log0, rec, msgs, cnt)

    k2_ms, _ = time_launches(k2, batches=5, per_batch=10, warm=2)
    print(f"  engine at E={E}, M={M}, S={S}: {eng_ms:.2f} ms a step of {M} "
          f"messages = {eng_ms / M:.4f} ms a message (host loop); kernel 2 "
          f"at rec_k={S} with its log: {k2_ms:.4f} ms a step "
          f"({eng_ms / k2_ms:.0f}x) [{smi}]", flush=True)
    return dict(engine_ms_per_step=eng_ms, engine_ms_per_message=eng_ms / M,
                records_rec_k_s_ms=k2_ms)


def speed_grid_check(torch, count, smi):
    """(b) ``run_speed_grid`` on the card: every row's env-steps/s, kernel
    1 launched once a step (the warm-up step and the window table's
    replay of each configuration's L2 rows included)."""
    from vit_marl_tpu_torch.eval.speed_test import run_speed_grid

    rows, got, wall = drive(torch, count,
                            lambda: run_speed_grid(device=DEV, **SPEED_GRID))
    n_cfg = len(SPEED_GRID["agents_grid"]) * len(SPEED_GRID["n_data_msgs"])
    expect(got, {"book_scan": n_cfg * (SPEED_GRID["num_steps"] + 2)},
           "speed grid (each configuration: window table, warm-up, steps)")
    for r in rows:
        if not r["env_steps_per_sec"] > 0:
            raise AssertionError(f"speed grid row {r}")
    print(f"  speed grid in {wall:.1f}s: "
          + "; ".join(f"({r['n_mm']}, {r['n_exec']}) agents, "
                      f"{r['msgs_per_step']} messages a step: "
                      f"{r['env_steps_per_sec']} env-steps/s" for r in rows)
          + f"; kernel 1 launches {got['book_scan']} [{smi}]", flush=True)
    return rows, got["book_scan"]


def sweep_check(torch, count, smi):
    """(c) ``run_sweep`` on the card over two combinations of
    ``sweep_fine.yaml``'s grid (its two ``LR`` values, the other keys at
    their first), one update each: the rows, finite metrics, kernel 1's
    launches."""
    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.rl.sweep import run_sweep, split_sweep

    with open(SWEEP_CONFIG) as f:
        base, grid = split_sweep(yaml.safe_load(f))
    base["TOTAL_TIMESTEPS"] = base["NUM_ENVS"] * base["NUM_STEPS"]
    grid = {k: v if k == "LR" else v[:1] for k, v in grid.items()}
    _, tc = make_config(base)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "sweep.jsonl")
        rows, got, wall = drive(torch, count, lambda: run_sweep(
            base, grid, out_path=out, seed=SEED, device=DEV))
        with open(out) as f:
            lines = [json.loads(x) for x in f]
    expect(got, {"book_scan": 2 * (1 + rollout_steps(tc, 1))},
           "sweep (each run: window table, rollout)")
    if len(rows) != 2 or lines != json.loads(json.dumps(rows)):
        raise AssertionError(f"sweep rows {rows}, file {lines}")
    for r in rows:
        finite(r["final_metrics"], f"sweep {r['overrides']}")
    print(f"  sweep_fine grid, 2 runs x 1 update x {tc.num_steps} steps x "
          f"{tc.num_envs} envs in {wall:.1f}s: "
          + "; ".join(f"{r['overrides']} {r['wall_seconds']}s" for r in rows)
          + f"; kernel 1 launches {got['book_scan']} [{smi}]", flush=True)
    return rows


# the card's kernels of a PPO update by family, by the first substring of
# its name that matches (the rest: "other")
OP_FAMILIES = (("products", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
               ("layer norm", ("layer_norm",)),
               ("GELU", ("gelu",)),
               ("copies and casts", ("copy", "cast", "fill", "memcpy",
                                     "memset")),
               ("optimizer", ("multi_tensor", "foreach", "adam")),
               ("attention kernels", ("attn_",)),
               ("book scan", ("book_scan",)),
               ("softmax and losses", ("softmax", "log_", "nll")),
               ("reductions", ("reduce",)),
               ("other elementwise", ("elementwise",)))


def op_family(name):
    low = name.lower()
    for family, keys in OP_FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def ppo_split(torch, count, make_train, smi):
    """(d) One update (one PPO epoch) of ``ippo_vision_dual_ppo.yaml``
    under ``utils/profiling.py::trace`` with its drain: the launches
    exact; the card's kernels from the Chrome trace it writes, by family
    and the ten with the most time; the trace's size."""
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS
    from vit_marl_tpu_torch.utils.profiling import kernel_events, trace

    ma, tc = config_with(VISION_CONFIG, ["UPDATE_EPOCHS=1"])
    train = make_train(ma, tc, device=DEV)
    names = {}
    with tempfile.TemporaryDirectory() as d:
        tt = time.perf_counter()
        with trace(d, drain=True) as prof:
            out, got, wall = drive(torch, count,
                                   lambda: train(tc.seed, n_updates=1))
        traced = time.perf_counter() - tt
        trace_mb = os.path.getsize(prof.trace_path) / 2**20
        for ev in kernel_events(prof.trace_path):
            n, t = names.get(ev["name"], (0, 0.0))
            names[ev["name"]] = (n + 1, t + float(ev["dur"]))
    expect(got, vision_launches(tc, VIT_PRESETS[tc.vit_preset].depth, 1),
           "vision update under the profiler")
    finite(out["metrics"][0], "traced vision update")
    kernels = sorted(names.items(), key=lambda kv: -kv[1][1])
    total = sum(t for _, (_, t) in kernels)
    if not total > 0:
        raise AssertionError("the profiler saw no kernel on the card")
    families = {}
    for name, (_, t) in kernels:
        f = op_family(name)
        families[f] = families.get(f, 0.0) + t
    m = out["metrics"][0]
    print(f"  vision update (1 PPO epoch, {tc.num_envs} envs x "
          f"{tc.num_steps} steps) traced: {wall:.2f}s (rollout "
          f"{m['rollout_s']:.2f}s, PPO {m['update_s']:.2f}s), "
          f"{traced:.1f}s with the trace's export ({trace_mb:.0f} MiB); "
          f"kernel time {total / 1e3:.1f} ms in "
          f"{sum(n for _, (n, _) in kernels)} kernels of {len(kernels)} "
          "names; by family: " + ", ".join(
              f"{f} {t / 1e3:.1f} ms ({t / total:.1%})" for f, t in sorted(
                  families.items(), key=lambda kv: -kv[1]))
          + f"; the {TOP_OPS} largest [{smi}]:", flush=True)
    for name, (n, t) in kernels[:TOP_OPS]:
        print(f"    {t / 1e3:9.2f} ms {t / total:6.1%} x{n:<7d} "
              f"{name[:110]}", flush=True)
    return dict(kernel_ms=total / 1e3, by_family={
        f: t / 1e3 for f, t in families.items()}, top=[
            (name[:110], t / 1e3) for name, (_, t) in kernels[:TOP_OPS]])


def tools_phase(torch, attn, bkern, blk, make_train, smi):
    """Phase 21: (a) the engine on the card against the CPU and kernel 2,
    and its time; (b) the speed grid; (c) the sweep; (d) the PPO update's
    split, each path driven with every count set to 0 just before it."""
    count = counters(attn, bkern, blk)
    t0 = [time.perf_counter()]

    def part(label):
        now = time.perf_counter()
        print(f"  21{label}: {now - t0[0]:.2f}s", flush=True)
        t0[0] = now

    res = dict(fills=engine_checks(torch, smi))
    res.update(engine_timing(torch, bkern, smi))
    part("a, the engine")
    res["speed_grid"], res["speed_grid_launches"] = speed_grid_check(
        torch, count, smi)
    part("b, the speed grid")
    res["sweep"] = sweep_check(torch, count, smi)
    part("c, the sweep")
    res["ppo_split"] = ppo_split(torch, count, make_train, smi)
    part("d, the PPO update's split")
    return res


# ---------------------------------------------------------------------------
# phase 22: the book scan at every capacity (the upstream's 100 orders a
# side), the per-env API on the card, the engine fuzzer
# ---------------------------------------------------------------------------

CAPACITIES = (2, 24, 100, 200, 384, 1024)   # the masked route's capacities
EXACT_CHECKS = (32, 64, 256)                # the exact route's, but 128
CAPACITY_E = 1024
UPSTREAM_ORDERS = 100
CAPACITY_TURNS = (128, 100, 100, 128)       # S, timed in turns at E=4,096
WIDE_S = 1024
WIDE_REC_K = 256        # records a message at S >= 256 in the checks
REC_K_DEBUG = REC_KS[0]
ENV_API_STEPS = 8
FUZZ_MINUTES = 0.5


def capacity_case(torch, S, mode, seed, kind, E=None):
    """(msgs, book, prev, uniforms) on the card at E envs (CAPACITY_E),
    M_MAIN: ``random`` streams or ``corners`` (make_corner_case), both with
    sweeps of a whole side, or ``negative``: full bid sides at prices below
    -1 (``torch_cases.full_negative_bids``)."""
    from torch_cases import (add_sweeps, full_negative_bids, make_case,
                             make_corner_case)
    from vit_marl_tpu_torch.lob.book import BookState

    E, M = E or CAPACITY_E, M_MAIN
    maker = make_corner_case if kind == "corners" else make_case
    book, msgs, prev = maker(E, M, S, seed, tids=AGENT_TIDS)
    msgs = add_sweeps(msgs, every=5, seed=seed)
    if kind == "negative":
        book, msgs = full_negative_bids(book, msgs, seed)
    u = np.random.default_rng(seed).random((M, E), dtype=np.float32)
    return (torch.from_numpy(msgs).to(DEV),
            BookState(torch.from_numpy(book).to(DEV)),
            torch.from_numpy(prev).to(DEV), torch.from_numpy(u).to(DEV))


def both_kernels_equal(torch, bkern, cfg, case, rec_k, label):
    """Kernels 1 and 2 against their plain versions on one case, every
    output bit-equal; returns the fills."""
    msgs, book, prev, u = case
    tids = torch.tensor(AGENT_TIDS, dtype=torch.int32, device=DEV)
    got = bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK, u)
    want = bkern.process_step_aggs_reference(cfg, msgs, book, tids, prev,
                                             TICK, u)
    got2 = bkern.process_step_records(cfg, msgs, book, prev, rec_k, u)
    want2 = bkern.process_step_records_reference(cfg, msgs, book, prev,
                                                 rec_k, u)
    for k, (g, w) in (("kernel 1", (got, want)), ("kernel 2", (got2, want2))):
        pairs = [(g[0].data, w[0].data), (g[1][0], w[1][0]),
                 (g[1][1], w[1][1]), (g[2][0], w[2][0]), (g[2][1], w[2][1])]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{k} != plain at {label}")
    return int(want2[2][1].sum())


def capacity_checks(torch, bkern, smi):
    """Kernels 1 and 2 against their plain versions at every capacity of
    CAPACITIES (the masked route) in cancel modes 0 (random streams) and 3
    (corner streams), both with sweeps, on full negative bid books at the
    masked route's smallest slot maps, and at EXACT_CHECKS in mode 1;
    records at rec_k min(16, S) in mode 0 and min(S, WIDE_REC_K) in mode
    3 (``debug_mode`` keeps n_orders in modes 2-3).  Prints each route's
    launch plan."""
    from vit_marl_tpu_torch.config import EngineConfig

    for S in CAPACITIES:
        for n_agg, rec_k in ((2, 1), (None, min(16, S)),
                             (None, min(S, WIDE_REC_K))):
            plan = bkern.launch_plan(S, n_agg, DEV, rec_k)
            print(f"  book scan launch plan, S={S}, "
                  + (f"records, rec_k={rec_k}" if n_agg is None
                     else f"n_agg={n_agg}") + ": "
                  + ", ".join(f"{k} {v}" for k, v in plan.items()),
                  flush=True)
    checks = [(S, 0, "random") for S in CAPACITIES]
    checks += [(S, 3, "corners") for S in CAPACITIES]
    checks += [(S, 1, "negative") for S in (24, UPSTREAM_ORDERS)]
    checks += [(S, 1, "corners") for S in EXACT_CHECKS]
    for S, mode, kind in checks:
        rec_k = min(16, S) if mode < 2 else min(S, WIDE_REC_K)
        fills = both_kernels_equal(
            torch, bkern, EngineConfig(n_orders=S, cancel_mode=mode),
            capacity_case(torch, S, mode, SEED + 7 * S + mode, kind), rec_k,
            f"S={S}, mode {mode}, {kind}")
        print(f"  S={S}, cancel mode {mode}, {kind} streams: kernels 1 and "
              f"2 bit-equal to their plain versions (E={CAPACITY_E}, "
              f"rec_k={rec_k}, {fills} fills) [{smi}]", flush=True)
    return len(checks)


def capacity_timing(torch, bkern, smi):
    """Kernels 1 and 2 at E=4,096, M=112 in the 2-player path's cancel mode
    (1): S=128 and S=100 in turns (CAPACITY_TURNS), the masked route at
    S=128 on S=128's data (what the masks cost; ``torch_cases.
    launch_slot_map``), and S=1,024; the plain versions, each output
    bit-equal to the kernels' on the same inputs, and the bounds; then
    both kernels in the ``debug_mode`` path's cancel mode 3 at S=100,
    records at rec_k 100, against their plain versions.  Returns the rows
    by S."""
    from torch_cases import launch_slot_map, make_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import BookState

    tids = torch.tensor(AGENT_TIDS, dtype=torch.int32, device=DEV)
    data = {}
    for S in sorted(set(CAPACITY_TURNS) | {WIDE_S}):
        book, msgs, prev = make_case(E_MAIN, M_MAIN, S, SEED + S,
                                     tids=AGENT_TIDS)
        data[S] = (torch.from_numpy(msgs).to(DEV),
                   BookState(torch.from_numpy(book).to(DEV)),
                   torch.from_numpy(prev).to(DEV))
    cfgs = {S: EngineConfig(n_orders=S, cancel_mode=1) for S in data}
    lib = bkern._library()
    masked = lambda S: (  # noqa: E731
        lambda: launch_slot_map(lib, cfgs[S], *data[S], 4, True, tids=tids),
        lambda: launch_slot_map(lib, cfgs[S], *data[S], 4, True,
                                rec_k=REC_K_DEBUG))
    rows = {}

    def timed(S, label, fns=None):
        msgs, book, prev = data[S]
        cfg = cfgs[S]
        k1, k2 = fns or (
            lambda: bkern._launch(cfg, msgs, book, tids, prev, TICK, None),
            lambda: bkern._launch_records(cfg, msgs, book, prev,
                                          REC_K_DEBUG, None))
        k1, k2 = time_launches(k1), time_launches(k2)
        print(f"  {label}: kernel 1 {k1[0]:.4f} ms (min {k1[1]:.4f}), "
              f"kernel 2 at rec_k {REC_K_DEBUG} {k2[0]:.4f} ms (min "
              f"{k2[1]:.4f}) a launch at E={E_MAIN} [{smi}]", flush=True)
        return k1[0], k2[0]

    for S in CAPACITY_TURNS:
        rows.setdefault(S, dict(ms=[], records_ms=[]))
        k1, k2 = timed(S, f"S={S}, {'masked' if S != 128 else 'exact'}")
        rows[S]["ms"].append(k1)
        rows[S]["records_ms"].append(k2)
    rows["128_masked"] = dict(zip(("ms", "records_ms"), timed(
        128, "S=128 on the masked route (4 slots a lane)", masked(128))))
    rows[WIDE_S] = dict(zip(("ms", "records_ms"), timed(
        WIDE_S, f"S={WIDE_S}, masked")))
    for S in (128, UPSTREAM_ORDERS, WIDE_S):
        msgs, book, prev = data[S]
        cfg = cfgs[S]
        plain, want = [], []
        for fn in (lambda: bkern.process_step_aggs_reference(
                       cfg, msgs, book, tids, prev, TICK),
                   lambda: bkern.process_step_records_reference(
                       cfg, msgs, book, prev, REC_K_DEBUG)):
            torch.cuda.synchronize()
            tp = time.perf_counter()
            want.append(fn())
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - tp) * 1e3)
        got = {"": (bkern.process_step_aggs(cfg, msgs, book, tids, prev,
                                            TICK),
                    bkern.process_step_records(cfg, msgs, book, prev,
                                               REC_K_DEBUG))}
        if S == 128:
            got[" (masked route)"] = tuple(f() for f in masked(128))
        for route, outs in got.items():
            for k, g, w in zip((1, 2), outs, want):
                pairs = [(g[0].data, w[0].data), *zip(g[1], w[1]),
                         *zip(g[2], w[2])]
                if not all(torch.equal(x, y) for x, y in pairs):
                    raise AssertionError(f"kernel {k}{route} != plain at "
                                         f"S={S}, E={E_MAIN}, mode 1")
        r = rows[S]
        r.update(plain_ms=plain[0], records_plain_ms=plain[1],
                 bound_ms=scan_bytes(E_MAIN, M_MAIN, S, len(AGENT_TIDS))
                 / HBM_BYTES_PER_S * 1e3,
                 records_bound_ms=records_bytes(E_MAIN, M_MAIN, S,
                                                REC_K_DEBUG, 1)
                 / HBM_BYTES_PER_S * 1e3)
        print(f"  S={S}: kernels 1 and 2" + (", and both on the masked "
              "route," if S == 128 else "") + " bit-equal to their plain "
              f"versions at E={E_MAIN}, mode 1; plain {plain[0]:.2f} / "
              f"{plain[1]:.2f} ms (kernel 1 / 2); bounds "
              f"{r['bound_ms']:.4f} / {r['records_bound_ms']:.4f} ms, "
              f"bytes [{smi}]", flush=True)
    S = UPSTREAM_ORDERS
    fills = both_kernels_equal(
        torch, bkern, EngineConfig(n_orders=S, cancel_mode=3),
        capacity_case(torch, S, 3, SEED + 3 * S, "random", E=E_MAIN), S,
        f"S={S}, mode 3, E={E_MAIN}")
    print(f"  S={S}, cancel mode 3 (debug_mode's path): kernels 1 and 2 "
          f"(rec_k={S}) bit-equal to their plain versions at E={E_MAIN} "
          f"({fills} fills) [{smi}]", flush=True)
    return rows


class RecordedScans:
    """Every ``rl/scan.py::ScanRollout`` a trainer makes inside the
    block, kept to read its graph replays after."""

    def __init__(self):
        self.made = []

    def __enter__(self):
        from vit_marl_tpu_torch.rl import ppo as tppo

        made, base = self.made, tppo.ScanRollout

        class Kept(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        self._ppo, self._base = tppo, base
        tppo.ScanRollout = Kept
        return self

    def __exit__(self, *exc):
        self._ppo.ScanRollout = self._base


def orders_training(torch, count, make_train, smi, orders, runs):
    """One update (one PPO epoch) of ``ippo_2player.yaml`` at ``orders``
    orders a side, on the graph, for each run of ``runs``: (label, its
    ``--set`` overrides, the book scan's count name).  Returns each run's
    kernel launches, the wrappers' (the warm-up step) and the graph's (its
    book-scan nodes times the replays counted), and seconds; and the first
    run's env."""
    out, env = {}, None
    for label, sets, name in runs:
        ma, tc = config_with(CONFIG, [f"WORLD.N_ORDERS={orders}",
                                      "UPDATE_EPOCHS=1", *sets])
        with RecordedScans() as rec:
            m, got, train, _ = train_once(
                torch, count, make_train, ma, tc,
                {name: rollout_steps(tc, 1)}, f"2-player, {label}", smi)
        env = env or train.env
        scan = rec.made[-1]
        nodes = graph_nodes(scan.graph).get("book_scan", 0)
        if scan.replays != tc.num_steps or nodes != 1:
            raise AssertionError(f"{label}: the graph replayed "
                                 f"{scan.replays} times with {nodes} book "
                                 "scan nodes")
        out[label] = dict(wrapper=got[name], graph=nodes * scan.replays,
                          rollout_s=m["rollout_s"], update_s=m["update_s"])
        print(f"  {label}: kernel {1 if name == 'book_scan' else 2} "
              f"launched {got[name]} time through the wrapper (the warm-up) "
              f"and {nodes * scan.replays} on the graph ({scan.replays} "
              f"replays); rollout {m['rollout_s']:.3f}s, PPO "
              f"{m['update_s']:.3f}s [{smi}]", flush=True)
    return out, env


def upstream_training(torch, count, make_train, smi):
    """:func:`orders_training` at 100 orders a side, 4,096 envs x 128
    steps; then the same in ``debug_mode`` with cancel mode 3 (kernel 2
    at rec_k 100)."""
    return orders_training(torch, count, make_train, smi, UPSTREAM_ORDERS, (
        (f"n_orders={UPSTREAM_ORDERS}", [], "book_scan"),
        (f"n_orders={UPSTREAM_ORDERS}, debug_mode, cancel mode 3",
         ["WORLD.DEBUG_MODE=true", "WORLD.CANCEL_MODE=3"],
         "book_scan_records")))


def env_draws(d):
    """One env's draws of a batch of one (``draw_step(1, ...)``), as the
    per-env API takes them."""
    from vit_marl_tpu_torch.env.structs import ResetDraws, StepDraws
    from vit_marl_tpu_torch.utils.tree import tree_map

    first = lambda t: tree_map(lambda v: v[0], t)  # noqa: E731
    return StepDraws(
        shuffle=None if d.shuffle is None else d.shuffle[0],
        uniforms=None if d.uniforms is None else d.uniforms[:, 0],
        reset=ResetDraws(window=d.reset.window[0],
                         agents=first(d.reset.agents)),
        agents=first(d.agents))


def env_api_check(torch, env_card, smi):
    """``reset_env`` and ENV_API_STEPS ``step``s of the 2-player world at
    100 orders a side with actions sampled from its spaces, on the card
    and on the CPU with the same draws: integer leaves bit-equal, float
    ones within 1e-5 (the tests' tolerance).  Returns ms a step on the
    card."""
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.utils.tree import tree_leaves, tree_map

    ma, _ = config_with(CONFIG, [f"WORLD.N_ORDERS={UPSTREAM_ORDERS}"])
    env_cpu = WorldEnv(ma, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    to_card = lambda t: tree_map(lambda v: v.to(DEV), t)  # noqa: E731
    params = {"cpu": env_cpu.default_params, DEV: env_card.default_params}
    reset = env_draws(env_cpu.draw_step(1, gen)).reset
    outs = {"cpu": env_cpu.reset_env(reset, params["cpu"]),
            DEV: env_card.reset_env(to_card(reset), params[DEV])}
    states = {k: v[1] for k, v in outs.items()}

    def same(a, b, label):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            y = y.cpu()
            if x.is_floating_point():
                ok = torch.allclose(x, y, rtol=1e-5, atol=1e-5)
            else:
                ok = torch.equal(x, y)
            if not ok:
                raise AssertionError(f"per-env API, card != CPU: {label}")

    same(outs["cpu"], outs[DEV], "reset_env")
    dones = fills = 0
    step_s = 0.0
    for t in range(ENV_API_STEPS):
        draws = env_draws(env_cpu.draw_step(1, gen))
        acts = [sp.sample(gen) for sp in env_cpu.action_space()]
        outs["cpu"] = env_cpu.step(states["cpu"], acts, params["cpu"],
                                   draws=draws)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        outs[DEV] = env_card.step(states[DEV], to_card(acts), params[DEV],
                                  draws=to_card(draws))
        torch.cuda.synchronize()
        step_s += time.perf_counter() - ts
        same(outs["cpu"][:4], outs[DEV][:4], f"step {t}")
        states = {k: v[1] for k, v in outs.items()}
        dones += int(outs["cpu"][3]["__all__"])
        fills += int((states["cpu"].world.trades[:, 0] != -1).sum())
    ms = step_s * 1e3 / ENV_API_STEPS
    print(f"  per-env API at n_orders={UPSTREAM_ORDERS}: reset_env and "
          f"{ENV_API_STEPS} steps (sampled actions, {fills} fills logged, "
          f"{dones} auto-resets) equal on the card and the CPU; "
          f"{ms:.1f} ms a step on the card [{smi}]", flush=True)
    return ms


def capacity_phase(torch, attn, bkern, blk, make_train, smi):
    """Phase 22: (a) kernels 1 and 2 at every capacity against their plain
    versions; (b) their times at S=100 against S=128 and at S=1,024; (c)
    one update at 100 orders a side, default and ``debug_mode``, each
    driven with every count set to 0 just before it; (d) the per-env API
    on the card against the CPU; (e) the engine fuzzer with its kernel
    checks."""
    import torch_fuzz_engine

    count = counters(attn, bkern, blk)
    t0 = [time.perf_counter()]

    def part(label):
        now = time.perf_counter()
        print(f"  22{label}: {now - t0[0]:.2f}s", flush=True)
        t0[0] = now

    res = dict(checks=capacity_checks(torch, bkern, smi))
    part("a, kernels 1 and 2 at every capacity")
    res["timing"] = capacity_timing(torch, bkern, smi)
    part("b, their times")
    res["training"], env = upstream_training(torch, count, make_train, smi)
    part("c, training at 100 orders a side")
    res["env_api_ms"] = env_api_check(torch, env, smi)
    part("d, the per-env API")
    rc = torch_fuzz_engine.main(["--kernel", "--minutes", str(FUZZ_MINUTES),
                                 "--device", DEV])
    if rc != 0:
        raise AssertionError(f"the engine fuzzer failed (exit {rc})")
    part("e, the engine fuzzer")
    return res


DEEP_CAPACITIES = (1025, 1500, 2048, 4096)   # the block route's, checked
DEEP_E = 256
DEEPEST, DEEPEST_E = 16_384, 32   # the book in device memory
DEEP_TIMED = (2048, 4096)         # timed at E=4,096 beside WIDE_S (22b)
BLOCK_AT = (512, WIDE_S)          # the block route against a warp's
DEEP_ORDERS = 2048
DEEP_DEBUG_ENVS = 512             # records of 2,048 fills: 1.9 GB a step
TOOL_REPS = ["--reps", "3"]


def print_plans(bkern, sizes):
    """Each capacity's launch plan for kernel 1 (2 traders) and kernel 2
    (rec_k 16 and S); returns them by S."""
    plans = {}
    for S in sizes:
        for n_agg, rec_k in ((2, 1), (None, 16), (None, S)):
            plan = bkern.launch_plan(S, n_agg, DEV, rec_k)
            plans.setdefault(S, {})["aggs" if n_agg else f"rec_k {rec_k}"] \
                = plan
            print(f"  book scan launch plan, S={S}, "
                  + (f"records, rec_k={rec_k}" if n_agg is None
                     else f"n_agg={n_agg}") + ": "
                  + ", ".join(f"{k} {v}" for k, v in plan.items()),
                  flush=True)
    return plans


def deep_checks(torch, bkern, smi):
    """Kernels 1 and 2 against their plain versions, bit-equal, on the
    block route: at DEEP_CAPACITIES and E=256 in cancel mode 0 (random
    streams, records at rec_k 16) and 3 (corner streams, rec_k = S, as
    ``debug_mode`` asks there), both with sweeps, and on full bid books
    below -1 at S=1,500 and 2,048; at DEEPEST (the book in device memory)
    and E=32 in modes 0 and 3."""
    from vit_marl_tpu_torch.config import EngineConfig

    checks = [(S, 0, "random", DEEP_E) for S in DEEP_CAPACITIES]
    checks += [(S, 3, "corners", DEEP_E) for S in DEEP_CAPACITIES]
    checks += [(S, 1, "negative", DEEP_E) for S in (1500, 2048)]
    checks += [(DEEPEST, 0, "random", DEEPEST_E),
               (DEEPEST, 3, "corners", DEEPEST_E)]
    for S, mode, kind, E in checks:
        rec_k = 16 if mode < 2 else S
        fills = both_kernels_equal(
            torch, bkern, EngineConfig(n_orders=S, cancel_mode=mode),
            capacity_case(torch, S, mode, SEED + 11 * S + mode, kind, E=E),
            rec_k, f"S={S}, mode {mode}, {kind}")
        print(f"  S={S}, cancel mode {mode}, {kind} streams: kernels 1 and "
              f"2 bit-equal to their plain versions (E={E}, rec_k={rec_k}, "
              f"{fills} fills) [{smi}]", flush=True)
    return [S for S, *_ in checks]


def deep_timing(torch, bkern, smi):
    """Kernels 1 and 2 (records at rec_k 16) at E=4,096, M=112, cancel
    mode 1 and S in DEEP_TIMED, through the wrappers, every output
    bit-equal to the plain versions timed on the same inputs, beside the
    bytes bounds; then the block route at BLOCK_AT against the warp
    route's kernels on the same data (``torch_cases.launch_slot_map``),
    bit-equal.  Returns the rows by S."""
    from torch_cases import launch_slot_map, make_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import BookState

    tids = torch.tensor(AGENT_TIDS, dtype=torch.int32, device=DEV)
    reps = dict(batches=5, per_batch=5, warm=2)
    lib = bkern._library()
    rows = {}

    def data(S):
        book, msgs, prev = make_case(E_MAIN, M_MAIN, S, SEED + S,
                                     tids=AGENT_TIDS)
        return (EngineConfig(n_orders=S, cancel_mode=1),
                torch.from_numpy(msgs).to(DEV),
                BookState(torch.from_numpy(book).to(DEV)),
                torch.from_numpy(prev).to(DEV))

    def same(got, want, label):
        pairs = [(got[0].data, want[0].data), *zip(got[1], want[1]),
                 *zip(got[2], want[2])]
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{label} at E={E_MAIN}, mode 1")

    for S in DEEP_TIMED:
        cfg, msgs, book, prev = data(S)
        k1 = time_launches(lambda: bkern._launch(cfg, msgs, book, tids, prev,
                                                 TICK, None), **reps)
        k2 = time_launches(lambda: bkern._launch_records(
            cfg, msgs, book, prev, REC_K_DEBUG, None), **reps)
        plain, want = [], []
        for fn in (lambda: bkern.process_step_aggs_reference(
                       cfg, msgs, book, tids, prev, TICK),
                   lambda: bkern.process_step_records_reference(
                       cfg, msgs, book, prev, REC_K_DEBUG)):
            torch.cuda.synchronize()
            tp = time.perf_counter()
            want.append(fn())
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - tp) * 1e3)
        same(bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK),
             want[0], f"kernel 1 != plain at S={S}")
        same(bkern.process_step_records(cfg, msgs, book, prev, REC_K_DEBUG),
             want[1], f"kernel 2 != plain at S={S}")
        del want
        rows[S] = dict(
            ms=k1[0], records_ms=k2[0], plain_ms=plain[0],
            records_plain_ms=plain[1],
            bound_ms=scan_bytes(E_MAIN, M_MAIN, S, len(AGENT_TIDS))
            / HBM_BYTES_PER_S * 1e3,
            records_bound_ms=records_bytes(E_MAIN, M_MAIN, S, REC_K_DEBUG, 1)
            / HBM_BYTES_PER_S * 1e3)
        r = rows[S]
        print(f"  S={S} (block route): kernel 1 {k1[0]:.4f} ms (min "
              f"{k1[1]:.4f}), kernel 2 at rec_k {REC_K_DEBUG} {k2[0]:.4f} ms "
              f"(min {k2[1]:.4f}) a launch at E={E_MAIN}, both bit-equal to "
              f"their plain versions ({plain[0]:.2f} / {plain[1]:.2f} ms); "
              f"bounds {r['bound_ms']:.4f} / {r['records_bound_ms']:.4f} ms, "
              f"bytes [{smi}]", flush=True)
    for S in BLOCK_AT:
        cfg, msgs, book, prev = data(S)
        warp = lambda: bkern._launch(cfg, msgs, book, tids, prev,  # noqa
                                     TICK, None)
        block = lambda: launch_slot_map(lib, cfg, msgs, book,  # noqa: E731
                                        prev, bkern.BLOCK_ROUTE, False,
                                        tids=tids)
        same(block(), warp(), f"the block route != the warp's at S={S}")
        times = [time_launches(fn, **reps)[0]
                 for fn in (warp, block, block, warp)]
        rows[f"{S}_block"] = dict(warp_ms=times[::3], block_ms=times[1:3])
        print(f"  S={S}, kernel 1 in turns (warp, block, block, warp): "
              + ", ".join(f"{t:.4f}" for t in times) + f" ms a launch at "
              f"E={E_MAIN}; the block route bit-equal to the warp's "
              f"[{smi}]", flush=True)
    return rows


def deep_phase(torch, attn, bkern, blk, make_train, smi):
    """Phase 23: (a) kernels 1 and 2 on the block route against their
    plain versions, and the routes' plans; (b) their times at S=2,048 and
    4,096, and the block route against the warp route at 512 and 1,024;
    (c) one update at 2,048 orders a side, and in ``debug_mode`` with
    cancel mode 3 at 512 envs, each driven with every count set to 0 just
    before it; (d) ``tools/torch_kernel_bench.py`` and
    ``tools/torch_profile_vit.py`` at the bench's shape."""
    import torch_kernel_bench
    import torch_profile_vit

    count = counters(attn, bkern, blk)
    t0 = [time.perf_counter()]

    def part(label):
        now = time.perf_counter()
        print(f"  23{label}: {now - t0[0]:.2f}s", flush=True)
        t0[0] = now

    res = dict(plans=print_plans(bkern, (*DEEP_CAPACITIES, DEEPEST)))
    res["checks"] = deep_checks(torch, bkern, smi)
    part("a, kernels 1 and 2 past 1,024 slots")
    res["timing"] = deep_timing(torch, bkern, smi)
    part("b, their times")
    res["training"], _ = orders_training(
        torch, count, make_train, smi, DEEP_ORDERS, (
            (f"n_orders={DEEP_ORDERS}", [], "book_scan"),
            (f"n_orders={DEEP_ORDERS}, debug_mode, cancel mode 3, "
             f"{DEEP_DEBUG_ENVS} envs",
             ["WORLD.DEBUG_MODE=true", "WORLD.CANCEL_MODE=3",
              f"NUM_ENVS={DEEP_DEBUG_ENVS}"], "book_scan_records")))
    part(f"c, training at {DEEP_ORDERS} orders a side")
    for tool in (torch_kernel_bench, torch_profile_vit):
        rc = tool.main(TOOL_REPS)
        if rc != 0:
            raise AssertionError(f"{tool.__name__} failed (exit {rc})")
    part("d, the kernel A/B and ViT stage tools")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    sys.path.insert(2, os.path.join(ROOT, "tools"))
    from torch_cases import add_sweeps, make_case, make_corner_case
    from vit_marl_tpu_torch.config import EngineConfig, load_yaml_config
    from vit_marl_tpu_torch.lob.book import BookState
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import block_kernel as blk
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl.ppo import make_train

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device and build ----
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    tb = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(m.build_library) for m in (bkern, attn, blk)]
        libs = [f.result() for f in builds]
    for m in (bkern, attn, blk):
        m._library()
    print(f"built {', '.join(os.path.relpath(x, ROOT) for x in libs)} in "
          f"{time.perf_counter() - tb:.2f}s", flush=True)
    for S in (32, 64, 128, 256):
        for n_agg, rec_k in ((None, 16), (None, S), (1, 1), (2, 1), (3, 1)):
            plan = bkern.launch_plan(S, n_agg, dev, rec_k)
            print(f"  book scan launch plan, S={S}, "
                  + (f"records, rec_k={rec_k}" if n_agg is None
                     else f"n_agg={n_agg}") + ": "
                  + ", ".join(f"{k} {v}" for k, v in plan.items()),
                  flush=True)
    hidden = MLP_RATIO * ATT_W
    for name in TC_KERNELS:
        shape = tc_shape(name, ATT_W, hidden)
        info = blk.wgmma_info(name, ATT_W, *shape)
        what = {"fused_ln_qkv": f", K {shape[0]}",
                "fused_ln_qkv_attn": ""}.get(name, f", hidden {shape[0]}")
        print(f"  {name} bf16 tensor-core plan at W={ATT_W}{what}"
              + (f", N={ATT_N}, H={ATT_H}" if shape[1:] else "")
              + ": " + ", ".join(f"{k} {v}" for k, v in info.items()),
              flush=True)
    phase("1 device", t0)

    # ---- phase 2: book scan against plain ----
    # Launches made here and in phases 3-5 only check and time the
    # kernels; phases 6-15 set the counts to 0 before they drive the paths
    # (the bench's selfcheck and phase 14's comparisons excepted).
    t0 = time.perf_counter()
    tids = torch.tensor(AGENT_TIDS, dtype=torch.int32, device=dev)
    max_err = 0

    def compare(cfg, msgs, book, prev, u, label):
        nonlocal max_err
        got = bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK, u)
        want = bkern.process_step_aggs_reference(cfg, msgs, book, tids,
                                                 prev, TICK, u)
        torch.cuda.synchronize()
        pairs = [(got[0].data, want[0].data), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1]), (got[2][0], want[2][0]),
                 (got[2][1], want[2][1])]
        err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                  for a, b in pairs)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"kernel != plain on {label}: "
                                 f"max abs err {err}")
        n_fill = int(want[2][1][:, 0].sum())
        print(f"  {label}: bit-equal (E={msgs.shape[0]}, "
              f"{n_fill} shares filled)", flush=True)

    def case(E, seed, corners=False):
        make = make_corner_case if corners else make_case
        book, msgs, prev = make(E, M_MAIN, S_MAIN, seed, tids=AGENT_TIDS)
        u = np.random.default_rng(seed).random((M_MAIN, E), dtype=np.float32)
        return (torch.from_numpy(msgs).to(dev),
                BookState(torch.from_numpy(book).to(dev)),
                torch.from_numpy(prev).to(dev),
                torch.from_numpy(u).to(dev))

    cases = {}
    for mode in range(4):
        cfg = EngineConfig(n_orders=S_MAIN, cancel_mode=mode)
        cases[mode] = case(E_MAIN, SEED + mode)
        compare(cfg, *cases[mode], f"random streams, cancel mode {mode}")
        compare(cfg, *case(E_MAIN, SEED + 5 + mode, corners=True),
                f"corner streams, cancel mode {mode}")
    cfg = EngineConfig(n_orders=S_MAIN, cancel_mode=1)
    compare(cfg, *case(1000, SEED + 4), "random streams, E=1000")

    ma, tc = load_yaml_config(CONFIG)
    if tc.num_envs != E_MAIN:
        raise AssertionError(f"{CONFIG}: NUM_ENVS {tc.num_envs}")
    train = make_train(ma, tc, device=dev)
    env = train.env
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = env.default_params
    _, state = env.reset(env.draw_reset(E_MAIN, gen), params)
    actions = [torch.randint(0, sp.n, (E_MAIN,), generator=gen, device=dev)
               for sp in env.action_spaces]
    draws = env.draw_step(E_MAIN, gen)
    combined, _ = env._build_messages(
        state, env._actions(actions), params, draws.shuffle)
    prev = torch.stack([state.world.best_asks[:, -1, 0],
                        state.world.best_bids[:, -1, 0]], 1)
    env_tids = torch.cat([p.trader_id for p in params.agents])
    if combined.shape != (E_MAIN, M_MAIN, 8) or not torch.equal(
            env_tids, tids):
        raise AssertionError("main-path stream shape or trader ids differ")
    compare(ma.world, combined, state.world.books, prev, draws.uniforms,
            "stream from the env's message builder")

    # Timing at the 2-player path's shape and cancel mode; the host issues
    # each batch faster than the card runs it, so the events span only
    # kernels.
    msgs, book, prev, u = cases[int(ma.world.cancel_mode)]
    cfg = EngineConfig(n_orders=S_MAIN, cancel_mode=ma.world.cancel_mode)
    plan = bkern.launch_plan(S_MAIN, len(AGENT_TIDS), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = {E: -(-E // (plan["warps_per_sm"] * sms))
             for E in SCAN_LAUNCHES}
    print(f"  launch plan: {plan['registers']} registers a thread, "
          f"{plan['spill_bytes']} spill bytes, {plan['dynamic_smem']} B of "
          f"shared memory a block, {plan['warps_per_sm']} warps an SM on "
          f"{sms} SMs: waves {waves}", flush=True)

    def launch():
        return bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK, u)

    kernel_ms, kernel_min = time_launches(launch)
    th = time.perf_counter()
    for _ in range(PER_BATCH):
        launch()
    host_ms = (time.perf_counter() - th) * 1e3 / PER_BATCH
    torch.cuda.synchronize()
    if host_ms >= kernel_ms:
        print(f"  warning: the host issues a launch in {host_ms:.4f} ms, "
              "not faster than the card runs it; the kernel time includes "
              "host waits", flush=True)
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        tp = time.perf_counter()
        bkern.process_step_aggs_reference(cfg, msgs, book, tids, prev, TICK,
                                          u)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - tp) * 1e3)
    plain_ms = float(np.median(plain))
    nbytes = scan_bytes(E_MAIN, M_MAIN, S_MAIN, len(AGENT_TIDS))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  E={E_MAIN}: kernel {kernel_ms:.4f} ms per launch (median of "
          f"{BATCHES} batches of {PER_BATCH} back-to-back launches, min "
          f"{kernel_min:.4f}); host issue {host_ms:.4f} ms per call; "
          f"plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"{SCAN_LAUNCHES[E_MAIN][1]} launches an update "
          f"({SCAN_LAUNCHES[E_MAIN][0]}) [{smi}]", flush=True)
    scan_rows = {E_MAIN: dict(ms=kernel_ms, bound_ms=bound_ms,
                              waves=waves[E_MAIN])}
    for E in [x for x in SCAN_LAUNCHES if x != E_MAIN]:
        m_, b_, p_, u_ = case(E, SEED + E)

        def launch_e():
            return bkern.process_step_aggs(cfg, m_, b_, tids, p_, TICK, u_)

        ms, ms_min = time_launches(launch_e)
        dev_ms = graph_ms(launch_e)
        bnd = scan_bytes(E, M_MAIN, S_MAIN, len(AGENT_TIDS)) \
            / HBM_BYTES_PER_S * 1e3
        scan_rows[E] = dict(ms=ms, bound_ms=bnd, waves=waves[E],
                            device_ms=dev_ms)
        print(f"  E={E}: kernel {ms:.4f} ms per launch (min {ms_min:.4f}); "
              f"on the card alone {dev_ms:.4f} ms (CUDA graph of "
              f"{PER_BATCH}; the wrapper's time is the host's where that is "
              f"longer); bound {bnd:.4f} ms; {SCAN_LAUNCHES[E][1]} launches "
              f"an update ({SCAN_LAUNCHES[E][0]}) [{smi}]", flush=True)
    sets = [case(E_MAIN, SEED + 40 + i) for i in range(3)]
    turn = iter(range(10**9))

    def cold():
        m_, b_, p_, u_ = sets[next(turn) % len(sets)]
        return bkern.process_step_aggs(cfg, m_, b_, tids, p_, TICK, u_)

    cold_ms, cold_min = time_launches(cold)
    del sets
    inputs = sum(t.numel() * 4 for t in (msgs, book.data, prev, u))
    print(f"  E={E_MAIN}, cold L2 (launches rotate over 3 input sets of "
          f"{inputs / 1e6:.1f} MB, beyond the 50 MB L2): kernel "
          f"{cold_ms:.4f} ms per launch (min {cold_min:.4f}) [{smi}]",
          flush=True)
    phase("2 book scan against plain", t0)

    # ---- phase 3: records scan against plain ----
    t0 = time.perf_counter()

    def sweep_case(E, seed, corners=False):
        msgs, book, prev, u = case(E, seed, corners)
        swept = add_sweeps(msgs.cpu().numpy(), every=7, seed=seed)
        return torch.from_numpy(swept).to(dev), book, prev, u

    records = records_phase(torch, bkern, smi, sweep_case,
                            int(ma.world.cancel_mode))
    phase("3 records scan against plain", t0)

    # ---- phase 4: attention against plain ----
    t0 = time.perf_counter()
    att = attention_phase(torch, attn, smi)
    phase("4 attention against plain", t0)

    # ---- phase 5: fused blocks against plain ----
    t0 = time.perf_counter()
    fused = block_phase(torch, blk, smi)
    phase("5 fused blocks against plain", t0)

    # ---- phase 6: 2-player training ----
    t0 = time.perf_counter()
    count = counters(attn, bkern, blk)
    for _, reset in count.values():
        reset()
    torch.cuda.synchronize()
    tt = time.perf_counter()
    out = train(tc.seed, n_updates=UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tt
    launches = bkern.process_step_aggs.launches
    others = {k: get() for k, (get, _) in count.items()
              if k != "book_scan" and get()}
    if others:
        raise AssertionError("the 2-player path (GRU policies) launched the "
                             f"ViT's kernels: {others}")
    check_metrics(out["metrics"])
    want_launches = rollout_steps(tc, UPDATES)
    if launches != want_launches:
        raise AssertionError(f"book scan launched {launches} times, want "
                             f"{want_launches} (rollout_steps)")
    if not any("/info_" in k for k in out["metrics"][0]):
        raise AssertionError("LOG_ENV_INFO is on and no info metric came")
    obs_shapes = [tuple(s.shape) for s in env.observation_spaces]
    steps = tc.num_envs * tc.num_steps * UPDATES
    print(f"  {UPDATES} updates x NUM_STEPS={tc.num_steps} x NUM_ENVS="
          f"{tc.num_envs}: {steps} env-steps in {wall:.2f}s = "
          f"{steps / wall:.0f} env-steps/s; {update_split(out['metrics'])}; "
          f"book-scan launches {launches}, obs {obs_shapes} [{smi}]",
          flush=True)
    # the same path with the env-info metrics off, for their cost
    quiet = make_train(ma, dataclasses.replace(tc, log_env_info=False),
                       env=env)
    qout, qgot, qwall = drive(torch, count,
                              lambda: quiet(tc.seed, n_updates=UPDATES))
    expect(qgot, {"book_scan": want_launches}, "LOG_ENV_INFO=false")
    print("  rollout_s with LOG_ENV_INFO on: "
          + ", ".join(f"{m['rollout_s']:.3f}" for m in out["metrics"])
          + "; off: " + ", ".join(f"{m['rollout_s']:.3f}"
                                  for m in qout["metrics"])
          + f" ({steps / qwall:.0f} env-steps/s off) [{smi}]", flush=True)
    reduce_kernels = info_reduce_kernels(torch, env, smi)
    phase("6 2-player training", t0)

    # ---- phase 7: debug-mode training ----
    t0 = time.perf_counter()
    dgot = debug_phase(torch, count, make_train, dev, smi, train,
                       steps / wall)
    phase("7 debug-mode training", t0)

    # ---- phase 8: vision training ----
    t0 = time.perf_counter()
    vision = vision_phase(torch, attn, bkern, blk, make_train,
                          load_yaml_config, dev, smi)
    phase("8 vision training", t0)

    # ---- phase 9: vision simplest-case training ----
    t0 = time.perf_counter()
    vision_phase(torch, attn, bkern, blk, make_train, load_yaml_config, dev,
                 smi, config=SIMPLEST_CONFIG)
    phase("9 vision simplest-case training", t0)

    # ---- phase 10: fused-mode vision training ----
    t0 = time.perf_counter()
    modes = {}
    for mode in ("attn_ln_fold", "fused_block", "fused_block_full"):
        modes[mode] = vision_phase(torch, attn, bkern, blk, make_train,
                                   load_yaml_config, dev, smi, mode,
                                   updates=1, epochs=1)
    phase("10 fused-mode vision training", t0)

    # ---- phase 11: the port's bench ----
    t0 = time.perf_counter()
    bench_phase(torch, attn, bkern, blk, smi)
    phase("11 bench", t0)

    # ---- phase 12: checkpoints and resume ----
    t0 = time.perf_counter()
    resume_phase(torch, attn, bkern, blk, make_train, load_yaml_config, dev,
                 smi)
    phase("12 checkpoint and resume", t0)

    # ---- phase 13: LOBSTER CSV data ----
    t0 = time.perf_counter()
    lobster_phase(torch, attn, bkern, blk, make_train, dev, smi)
    phase("13 LOBSTER-fed training", t0)

    # ---- phase 14: the fused modes at ViT-Base's width ----
    t0 = time.perf_counter()
    wide_block_phase(torch, attn, blk, smi)
    phase("14 fused modes at W=768", t0)

    # ---- phase 15: the entry module ----
    t0 = time.perf_counter()
    entry_phase(torch, attn, bkern, blk, smi)
    phase("15 entry forward", t0)

    # ---- phase 16: agent spaces and evaluation ----
    t0 = time.perf_counter()
    sweep_fine_phase(torch, count, make_train, smi)
    m126 = spaces_phase(torch, count, bkern, smi)
    phase("16 agent spaces", t0)

    # ---- phase 17: networks, layouts, pipeline, data parallelism ----
    t0 = time.perf_counter()
    s11 = slice11_phase(torch, attn, bkern, blk, make_train, smi)
    phase("17 networks, layouts, pipeline, data parallelism", t0)

    # ---- phase 18: kernels 5 and 7 past 32 tokens; the scan ----
    t0 = time.perf_counter()
    s12 = slice12_phase(torch, attn, bkern, blk, make_train, smi)
    phase("18 kernels 5 and 7 past 32 tokens, the rollout as a CUDA "
          "graph", t0)

    # ---- phase 19: greedy eval and evaluate.py as CUDA graphs ----
    t0 = time.perf_counter()
    evals = eval_graph_phase(torch, count, make_train, smi)
    phase("19 greedy eval and evaluate.py as CUDA graphs", t0)

    # ---- phase 20: the model mesh axis ----
    t0 = time.perf_counter()
    model_axis_phase(torch, make_train, smi)
    phase("20 a (1, 2) data x model mesh on the card", t0)

    # ---- phase 21: the engine, the speed grid, the sweep, the PPO split ----
    t0 = time.perf_counter()
    tools = tools_phase(torch, attn, bkern, blk, make_train, smi)
    phase("21 the order-book engine and the tools", t0)

    # ---- phase 22: every book capacity, the per-env API, the fuzzer ----
    t0 = time.perf_counter()
    cap = capacity_phase(torch, attn, bkern, blk, make_train, smi)
    phase("22 the book scan at every capacity, the per-env API, the "
          "fuzzer", t0)
    ct = cap["timing"]

    # ---- phase 23: the book scan past 1,024 slots, the tools ----
    t0 = time.perf_counter()
    deep = deep_phase(torch, attn, bkern, blk, make_train, smi)
    phase("23 the book scan past 1,024 slots, the kernel A/B and ViT "
          "stage tools", t0)
    ct.update(deep["timing"])
    by_s = lambda key: {str(S): ct[S][key]  # noqa: E731
                        for S in (128, UPSTREAM_ORDERS, WIDE_S, *DEEP_TIMED)}

    # ---- summary ----
    print(json.dumps({"kernels": [{
        "name": "book_scan_aggs",
        "route": "cuda",
        "source": "vit_marl_tpu_torch/ops/csrc/book_scan.cu",
        "replaces": "vit_marl_tpu/ops/book_kernel.py:580",
        "launches": launches,
        "launches_vision": vision["book_scan"],
        # phase 18: the graph's replays in one update's rollout, 2-player
        # and vision: the graph's nodes of the kernel times the replays
        # counted in a run, and the launches a profiler trace of the
        # first TRACE_STEPS steps holds
        "graph_launches_per_update": s12["scan_2player"][
            "graph_launches"]["book_scan"],
        "graph_launches_traced": s12["scan_2player"][
            "graph_launches_traced"]["book_scan"],
        "graph_launches_per_update_vision": s12["scan_vision"][
            "graph_launches"]["book_scan"],
        "graph_launches_traced_vision": s12["scan_vision"][
            "graph_launches_traced"]["book_scan"],
        "bit_equal": max_err == 0,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "ms_cold_l2": cold_ms,
        "ms_by_envs": {str(E): r["ms"] for E, r in scan_rows.items()},
        "device_ms_by_envs": {str(E): r["device_ms"]
                              for E, r in scan_rows.items()
                              if "device_ms" in r},
        "bound_ms_by_envs": {str(E): r["bound_ms"]
                             for E, r in scan_rows.items()},
        "waves_by_envs": {str(E): r["waves"] for E, r in scan_rows.items()},
        "registers": plan["registers"],
        "warps_per_sm": plan["warps_per_sm"],
        **m126,
        **s11["m220"],
        "launches_phase17": {k: s11[k]["book_scan"] for k in
                             ("cnn_gru", "gru_box", "long", "pipeline")},
        # phase 19: the 2-player greedy eval (4,096 envs x EVAL_STEPS),
        # graph and host loop, every run in turns
        "eval_env_steps_per_s": {
            how: [evals["2-player"]["steps"] / t for t in
                  evals["2-player"][how]] for how in ("graph", "loop")},
        "info_reduce_kernels": reduce_kernels,
        # phase 21: the speed grid's steps (and each configuration's
        # window table and warm-up step)
        "launches_speed_grid": tools["speed_grid_launches"],
        # phase 22: E=4,096, M=112, cancel mode 1 at S=128 (exact), 100
        # (masked, times in turns with 128's) and 1,024; the masked route
        # on S=128's data; one update at 100 orders a side
        "ms_by_capacity": by_s("ms"),
        "plain_ms_by_capacity": by_s("plain_ms"),
        "bound_ms_by_capacity": by_s("bound_ms"),
        "ms_masked_route_at_128": ct["128_masked"]["ms"],
        "launches_n_orders_100": cap["training"]["n_orders=100"],
        "capacities_checked": list(CAPACITIES) + list(EXACT_CHECKS)
        + sorted(set(deep["checks"])),
        # phase 23: the block route at E=4,096 against the warp route's
        # kernel on the same data, in turns; one update at 2,048 orders
        "ms_block_route": {str(S): ct[f"{S}_block"] for S in BLOCK_AT},
        "launches_n_orders_2048": deep["training"][
            f"n_orders={DEEP_ORDERS}"],
        "plans_by_capacity": {str(S): p["aggs"]
                              for S, p in deep["plans"].items()},
    }, dict(records, launches=dgot["book_scan_records"],
            bit_equal_m126=m126["bit_equal_m126"],
            graph_launches_per_update=s12["scan_debug"]["graph_launches"][
                "book_scan"],
            graph_launches_traced=s12["scan_debug"]["graph_launches_traced"][
                "book_scan"],
            ms_by_capacity=by_s("records_ms"),
            plain_ms_by_capacity=by_s("records_plain_ms"),
            bound_ms_by_capacity=by_s("records_bound_ms"),
            ms_masked_route_at_128=ct["128_masked"]["records_ms"],
            launches_n_orders_100_debug=cap["training"][
                "n_orders=100, debug_mode, cancel mode 3"],
            launches_n_orders_2048_debug=deep["training"][
                f"n_orders={DEEP_ORDERS}, debug_mode, cancel mode 3, "
                f"{DEEP_DEBUG_ENVS} envs"],
            plans_by_capacity={str(S): p[f"rec_k {S}"]
                               for S, p in deep["plans"].items()})]
      + [dict(att[k], launches=vision[k],
               launches_attn_ln_fold=modes["attn_ln_fold"][k],
               launches_pipeline=s11["pipeline"][k],
               launches_rows_3d=s11["layouts"][1][k],
               launches_41_tokens=s11["long"][k],
               graph_launches_per_update=s12["scan_vision"][
                   "graph_launches"].get(k, 0),
               graph_launches_traced=s12["scan_vision"][
                   "graph_launches_traced"].get(k, 0))
          for k in ("short_attention_fwd", "short_attention_bwd")]
      + [dict(fused[k], launches=modes[BLOCK_KERNELS[k][1]][k],
              launches_mode=BLOCK_KERNELS[k][1],
              **({"n41": s12["long"][k],
                  "launches_41_tokens": s12["long_training"][
                      BLOCK_KERNELS[k][1]][0][k],
                  # the fused-block kernels' launches of the graph's
                  # replays in one update's rollout at 41 tokens (three a
                  # call of kernel 7, two of kernel 5): nodes times the
                  # counted replays, and as a trace of TRACE_STEPS holds
                  # them
                  "graph_kernel_launches_41_tokens": s12["long_training"][
                      BLOCK_KERNELS[k][1]][1]["graph_launches"][
                          "fused_block"],
                  "graph_kernel_launches_41_tokens_traced": s12[
                      "long_training"][BLOCK_KERNELS[k][1]][1][
                          "graph_launches_traced"]["fused_block"]}
                 if k in LONG_KERNELS else {})) for k in BLOCK_KERNELS]
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
