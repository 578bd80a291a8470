"""Training CLI for the PyTorch port.

Usage:
  python -m vit_marl_tpu_torch.train --config configs/ippo_2player.yaml
  python -m vit_marl_tpu_torch.train --config configs/ippo_2player.yaml \
      --set NUM_ENVS=512 --set TOTAL_TIMESTEPS=196608
  python -m vit_marl_tpu_torch.train --config configs/ippo_2player.yaml \
      --set WORLD.DEBUG_MODE=true

Runs on the card; ``--device cpu`` (or ``--cpu``, the JAX CLI's flag)
runs the plain PyTorch path on the CPU.  The last line gives the run's
env-steps/s; ``--timing`` adds the JAX CLI's ``throughput:`` line after it
(both over the whole run, set-up and the first update's capture
included).
Each update's metrics go to ``LOG_BACKEND`` (``print``, ``jsonl`` to
``LOG_PATH``, ``wandb`` where installed, ``none``); ``CHECKPOINT_DIR``
saves the learners, and ``RESUME=true`` continues from its latest update:

  python -m vit_marl_tpu_torch.train --config configs/ippo_2player.yaml \
      --set CHECKPOINT_DIR=runs/ckpt --set LOG_BACKEND=jsonl \
      --set LOG_PATH=runs/metrics.jsonl
  python -m vit_marl_tpu_torch.train --config configs/ippo_2player.yaml \
      --set CHECKPOINT_DIR=runs/ckpt --set RESUME=true

Data parallel over several cards, one process a card (``MESH_SHAPE``
names as many data ranks as processes; each steps ``NUM_ENVS / ranks``
envs):

  torchrun --nproc-per-node 8 -m vit_marl_tpu_torch.train \
      --config configs/mesh_ippo_2player.yaml

With a ``model`` axis the split weights and their Adam moments are
stored as shards over the model ranks (``parallel/mesh.py``); the
processes are ``data x model`` ranks:

  torchrun --nproc-per-node 4 -m vit_marl_tpu_torch.train \
      --config configs/ippo_vision_dual_ppo.yaml \
      --set MESH_SHAPE=[2,2] --set MESH_AXES=[data,model]
"""

from __future__ import annotations

import argparse
import time

import torch

from vit_marl_tpu_torch.utils.cli import apply_set_overrides


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="YAML run config")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a config key; A.B=VALUE reaches a section")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu on request)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--timing", action="store_true",
                   help="print the JAX CLI's throughput line after "
                        "training")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the same as --device cpu)")
    args = p.parse_args(argv)
    if args.cpu:
        if args.device not in (None, "cpu"):
            p.error(f"--cpu and --device {args.device} disagree")
        args.device = "cpu"

    import dataclasses

    import yaml

    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.parallel.distributed import (
        DataGroup,
        initialize_distributed,
    )
    from vit_marl_tpu_torch.rl.ppo import make_train

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = yaml.safe_load(f) or {}
    apply_set_overrides(raw, args.set)
    ma_config, train_config = make_config(raw)
    if args.seed is not None:
        train_config = dataclasses.replace(train_config, seed=args.seed)

    initialize_distributed()
    group = DataGroup.current()
    device = args.device
    if group.world > 1:
        if not train_config.mesh_shape:
            raise ValueError(f"{group.world} processes were started but "
                             "MESH_SHAPE is unset")
        if device is None and torch.cuda.is_available():
            device = f"cuda:{torch.cuda.current_device()}"
    train = make_train(ma_config, train_config, device=device, group=group)
    env = train.env
    if group.world > 1:
        g = train.group         # the data group, cut by a model axis
        model = (f", model rank {g.model.rank} of {g.model.world}"
                 if g.model is not None else "")
        print(f"rank {group.rank} of {group.world}: data rank {g.rank} of "
              f"{g.world}{model}: {train_config.num_envs // g.world} envs",
              flush=True)
    print(f"device: {env.device} world: msgs/step={env.num_msgs_per_step} "
          f"train: envs={train_config.num_envs} "
          f"steps={train_config.num_steps} "
          f"updates={train_config.num_updates}", flush=True)
    t0 = time.perf_counter()
    out = train(train_config.seed)
    wall = time.perf_counter() - t0
    n_steps = (train_config.num_envs * train_config.num_steps
               * len(out["metrics"]))
    print(f"done: {len(out['metrics'])} updates, {n_steps} env-steps in "
          f"{wall:.1f}s ({n_steps / wall:.0f} env-steps/s over the run)")
    if args.timing:
        print(f"throughput: {n_steps / wall:.0f} env-steps/s (incl. "
              "set-up and capture; --timing, as the JAX CLI prints it)")
    return out


if __name__ == "__main__":
    main()
