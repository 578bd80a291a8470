"""Evaluation CLI: checkpoint restore + Learned-vs-Baseline combinations.

Port of ``vit_marl_tpu/evaluate.py``: restores trained policies from a
checkpoint of the port's trainer (``rl/checkpoint.py``; orbax trees of the
JAX package are not read), pairs them with fixed-action baselines on the
action space each type runs (the canonical baselines are the ``AvSt``
market maker and the ``twap`` execution agent, set in the config), rolls
out every Learned/Baseline combination, and writes ``combinations.json``
and the heatmap, triangular and per-episode plots.  Without a checkpoint
the "learned" policies are random (Discrete) or the action space's
midpoint (Box).

Usage:
  python -m vit_marl_tpu_torch.evaluate --config configs/ippo_2player.yaml \\
      --checkpoint-dir runs/ckpt --num-envs 64 --num-steps 50 \\
      --out-dir eval_out

Runs on the card, each label's rollout one CUDA graph of its step
replayed (``eval/combinations.py``); ``--set ROLLOUT_MODE=loop`` issues
every step from the host, as the trainer's option does.  ``--device
cpu`` runs on the CPU.  Where matplotlib is
not installed, the figures are not drawn: their data goes to
``episodes_{label}/trajectory.npz`` beside the JSON, and one line on
stderr names the figures left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from vit_marl_tpu_torch.utils.cli import apply_set_overrides


def _figure_names(names, labels):
    """The plot files a run with matplotlib writes, but for the per-info
    figures of each label's episode directory."""
    out = [f"heatmap_{n}.png" for n in names]
    out += [f"triangular_{n}.png" for n in names]
    out += [f"episodes_{c}/*.png" for c in labels]
    return out


def _save_trajectories(results, out_dir, env_indices):
    """The episode-plot envs' series of every label, as numpy arrays."""
    import numpy as np

    for combo, r in results.items():
        traj = r["traj"]
        rows = {}
        for i, rew in enumerate(traj["rewards"]):
            rows[f"rewards_{i}"] = rew[:, env_indices]
            rows[f"actions_{i}"] = traj["actions"][i][:, env_indices]
            for k, v in traj["agent_infos"][i].items():
                rows[f"info_{i}_{k}"] = v[:, env_indices]
        for k, v in traj["world_infos"].items():
            rows[f"world_{k}"] = v[:, env_indices]
        d = os.path.join(out_dir, f"episodes_{combo}")
        os.makedirs(d, exist_ok=True)
        np.savez_compressed(os.path.join(d, "trajectory.npz"), **{
            k: v.cpu().numpy() for k, v in rows.items()})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], dest="sets",
                   metavar="KEY=VALUE",
                   help="override a config key (must match the training "
                        "run's overrides, or the checkpoint won't restore)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="the trainer's CHECKPOINT_DIR; omit for random "
                        "'learned' policies (harness smoke test)")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--num-steps", type=int, default=50)
    p.add_argument("--out-dir", default="eval_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--episode-plot-envs", type=int, default=2,
                   help="number of envs to draw per-episode analysis "
                        "figures for (per L/B combo)")
    p.add_argument("--greedy", action="store_true",
                   help="take distribution modes instead of sampling "
                        "(default samples, matching the reference eval)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu on request)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import yaml

    from vit_marl_tpu_torch.config import make_config
    from vit_marl_tpu_torch.env.spaces import Box
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.eval.baselines import (
        FixedActionPolicy,
        LearnedPolicy,
        RandomPolicy,
    )
    from vit_marl_tpu_torch.eval.combinations import evaluate_combinations
    from vit_marl_tpu_torch.rl.ppo import make_network, rollout_mode

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = yaml.safe_load(f) or {}
    apply_set_overrides(raw, args.sets)
    ma_config, train_config = make_config(raw)
    env = WorldEnv(ma_config, device=args.device)
    params = env.default_params
    n_types = len(env.agent_types)

    def box_value(sp, value):
        """A fixed Box action of the space's shape (scalar bounds
        broadcast)."""
        return np.broadcast_to(np.asarray(value, np.float32), sp.shape)

    def bounds(sp):
        low, high = (b.cpu().numpy() if hasattr(b, "cpu") else b
                     for b in (sp.low, sp.high))
        return np.asarray(low, np.float32), np.asarray(high, np.float32)

    # learned policies (checkpoint restore, ref: baseline_JAXMARL.py:223-306)
    learned = []
    if args.checkpoint_dir:
        from vit_marl_tpu_torch.rl.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir)
        restored = mgr.restore()
        for i in range(n_types):
            net = make_network(train_config, i, env.action_spaces[i],
                               env.observation_spaces[i]).to(env.device)
            net.load_state_dict(restored["params"][i])
            net.eval()
            learned.append(LearnedPolicy(net))
        print(f"restored checkpoint step {mgr.latest_step()}")
    else:
        for i in range(n_types):
            sp = env.action_spaces[i]
            if isinstance(sp, Box):
                low, high = bounds(sp)
                learned.append(FixedActionPolicy(
                    box_value(sp, (low + high) / 2), continuous=True))
            else:
                learned.append(RandomPolicy(sp.n))
        print("no checkpoint given: using random policies as 'learned'")

    # baselines: fixed actions on whatever action space each type runs
    baseline = []
    for i in range(n_types):
        sp = env.action_spaces[i]
        if isinstance(sp, Box):
            baseline.append(FixedActionPolicy(box_value(sp, bounds(sp)[0]),
                                              continuous=True))
        else:
            baseline.append(FixedActionPolicy(0, n_actions=int(sp.n)))

    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed)
    results = evaluate_combinations(
        env, params, learned, baseline, args.num_envs, args.num_steps, gen,
        mode="greedy" if args.greedy else "sample",
        hidden_size=train_config.hidden_size,
        rollout_mode=rollout_mode(train_config.rollout_mode))

    os.makedirs(args.out_dir, exist_ok=True)
    summary = {combo: {"mean_rewards": r["mean_rewards"],
                       "episode_done_frac": r["episode_done_frac"]}
               for combo, r in results.items()}
    with open(os.path.join(args.out_dir, "combinations.json"), "w") as f:
        json.dump(summary, f, indent=2)
    names = [a.cfg.short_name for a in env.agent_types]
    n_ep_envs = min(args.num_envs, args.episode_plot_envs)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        _save_trajectories(results, args.out_dir, list(range(n_ep_envs)))
        print("matplotlib is not installed: figures not written: "
              + ", ".join(_figure_names(names, results))
              + f" (their series are in {args.out_dir}/episodes_*/"
              "trajectory.npz)", file=sys.stderr)
    else:
        from vit_marl_tpu_torch.eval.plotting import (
            combination_heatmap,
            episode_report,
            triangular_plot,
        )

        for i in range(n_types):
            combination_heatmap(
                results, i, names, save_path=os.path.join(
                    args.out_dir, f"heatmap_{names[i]}.png"))
            triangular_plot(
                results, i, save_path=os.path.join(
                    args.out_dir, f"triangular_{names[i]}.png"))
        # per-episode analysis figures for every L/B combination
        for combo, r in results.items():
            files = episode_report(
                r["traj"], os.path.join(args.out_dir, f"episodes_{combo}"),
                env_indices=range(n_ep_envs), agent_names=names)
            print(f"episode figures [{combo}]: {len(files)} written")
    print(json.dumps(summary, indent=2))
    print(f"wrote {args.out_dir}/combinations.json")
    return results


if __name__ == "__main__":
    main()
