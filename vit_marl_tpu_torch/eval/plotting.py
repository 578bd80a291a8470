"""Evaluation plots: combination heatmaps + per-episode trajectories.

Port of ``vit_marl_tpu/eval/plotting.py`` on the results of
:func:`vit_marl_tpu_torch.eval.combinations.evaluate_combinations` (tensors
on any device are read to the host).  Matplotlib only, imported inside
each function; every function returns the figure so callers can save or
display.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def combination_heatmap(results: Dict[str, dict], agent_index: int = 0,
                        agent_names: Sequence[str] = ("MM", "EXE"),
                        save_path: Optional[str] = None):
    """n x n Learned-vs-Baseline mean-reward heatmap for one agent type
    (ref: plotting_combinations.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(next(iter(results))) < 2:
        # single agent type: a 2x2 grid is meaningless; use the bar plot
        return triangular_plot(results, agent_index, save_path)

    labels = ["L", "B"]
    grid = np.full((2, 2), np.nan)
    for combo, summary in results.items():
        i = labels.index(combo[0])
        j = labels.index(combo[1])
        grid[i, j] = summary["mean_rewards"][agent_index]
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(grid, cmap="RdYlGn")
    ax.set_xticks([0, 1], [f"{agent_names[1]}: L", f"{agent_names[1]}: B"])
    ax.set_yticks([0, 1], [f"{agent_names[0]}: L", f"{agent_names[0]}: B"])
    for i in range(2):
        for j in range(2):
            if np.isfinite(grid[i, j]):
                ax.text(j, i, f"{grid[i, j]:.2f}", ha="center", va="center")
    ax.set_title(f"mean reward: {agent_names[agent_index]}")
    fig.colorbar(im)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def triangular_plot(results: Dict[str, dict], agent_index: int = 0,
                    save_path: Optional[str] = None):
    """Triangular BB/BL/LB/LL comparison (ref: simple_triangular_plot.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    combos = sorted(results)
    vals = [results[c]["mean_rewards"][agent_index] for c in combos]
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.bar(combos, vals)
    ax.set_ylabel("mean reward")
    ax.set_title(f"agent type {agent_index} across combinations")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def episode_feature_plot(traj: dict, agent_index: int, feature: str,
                         env_index: int = 0, save_path: Optional[str] = None):
    """Per-step plot of one agent info feature over an episode
    (ref: plotting_episodes.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = _np(traj["agent_infos"][agent_index][feature])
    series = series.reshape(series.shape[0], -1)[:, env_index]
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(series)
    ax.set_xlabel("step")
    ax.set_ylabel(feature)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def learning_curves(metrics_jsonl: str, save_path: Optional[str] = None,
                    smooth: int = 5):
    """Per-agent-type mean-reward training curves (plus held-out eval
    points when present) from a jsonl metrics log written by the trainer's
    jsonl backend (rl/logger.py)."""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [json.loads(line) for line in open(metrics_jsonl)]
    # resume appends: a run killed between checkpoints re-runs (and
    # re-logs) the updates since the last save — keep the LAST row per
    # update_step so curves stay monotonic and single-valued
    if rows and "update_step" in rows[0]:
        dedup = {}
        for r in rows:
            dedup[r.get("update_step")] = r
        rows = [dedup[k] for k in sorted(dedup)]
    names = sorted({k.split("/")[0] for k in rows[0] if "/" in k})
    fig, axes = plt.subplots(1, len(names), figsize=(5 * len(names), 3.2),
                             squeeze=False)
    for ax, name in zip(axes[0], names):
        steps = [r["update_step"] for r in rows if f"{name}/mean_reward" in r]
        vals = np.array([r[f"{name}/mean_reward"] for r in rows
                         if f"{name}/mean_reward" in r])
        if smooth > 1 and len(vals) > smooth:
            kern = np.ones(smooth) / smooth
            sm = np.convolve(vals, kern, mode="valid")
            ax.plot(steps, vals, alpha=0.25, color="C0")
            ax.plot(steps[smooth - 1:], sm, color="C0", label="train")
        else:
            ax.plot(steps, vals, color="C0", label="train")
        ev = [(r["update_step"], r[f"{name}/eval_mean_reward"])
              for r in rows if f"{name}/eval_mean_reward" in r]
        if ev:
            ax.plot(*zip(*ev), "o--", color="C1", label="held-out eval")
        ax.set_title(f"{name} mean reward")
        ax.set_xlabel("update")
        ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig


def _per_env_series(arr: np.ndarray, env_index: int) -> np.ndarray:
    """(T, num_envs, ...) -> (T, flattened-rest) for one env; (T,) passes
    through. Returns None for series too wide to plot (>8 lines)."""
    a = _np(arr).astype(np.float64)
    if a.ndim == 1:
        a = a[:, None]
    else:
        a = a[:, env_index].reshape(a.shape[0], -1)
    return a if a.shape[1] <= 8 else None


def episode_report(traj: dict, out_dir: str,
                   env_indices: Sequence[int] = (0,),
                   agent_names: Optional[Sequence[str]] = None) -> list:
    """Full per-episode analysis figure set for a combination rollout
    (ref: plotting_episodes.py:309-513 ``plot_episode_features``):

    - ``rewards.png``    — per-env subplots, one line per agent type;
    - ``actions.png``    — per-env x per-type grid (action dims as lines);
    - ``info_<key>.png`` — per-env subplots for every scalar agent-info
      feature (quant_left, inventory, PnL, ...), lines per agent type;
    - ``world.png``      — per-env mid price / best bid / best ask.

    ``traj`` is the dict returned by :func:`combinations.rollout`.
    Returns the list of files written.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    n_types = len(traj["rewards"])
    names = list(agent_names or [f"type{i}" for i in range(n_types)])
    n_env = len(env_indices)
    cmap = plt.get_cmap("viridis", max(n_types, 2))

    def _grid(n_rows, n_cols=1, w=9, h=3):
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(w * n_cols, h * n_rows),
                                 sharex=True, squeeze=False)
        return fig, axes

    # ---- rewards ---------------------------------------------------------
    fig, axes = _grid(n_env)
    for r, e in enumerate(env_indices):
        for i in range(n_types):
            s = _per_env_series(traj["rewards"][i], e)
            if s is None:
                continue
            for c in range(s.shape[1]):
                axes[r, 0].plot(s[:, c], color=cmap(i),
                                label=names[i] if c == 0 else None)
        axes[r, 0].set_title(f"env {e} rewards")
        axes[r, 0].grid(True, alpha=0.3)
        axes[r, 0].legend(frameon=False, fontsize=8)
    axes[-1, 0].set_xlabel("step")
    fig.tight_layout()
    path = os.path.join(out_dir, "rewards.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    written.append(path)

    # ---- actions ---------------------------------------------------------
    if "actions" in traj:
        fig, axes = _grid(n_env, n_types, w=6)
        for r, e in enumerate(env_indices):
            for i in range(n_types):
                s = _per_env_series(traj["actions"][i], e)
                ax = axes[r, i]
                if s is not None:
                    for c in range(s.shape[1]):
                        ax.plot(s[:, c], label=f"dim {c}" if s.shape[1] > 1
                                else None)
                    if s.shape[1] > 1:
                        ax.legend(frameon=False, fontsize=7)
                ax.set_title(f"env {e} {names[i]} actions")
                ax.grid(True, alpha=0.3)
        fig.tight_layout()
        path = os.path.join(out_dir, "actions.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)

    # ---- per-feature agent info -----------------------------------------
    keys = sorted({k for inf in traj["agent_infos"] for k in inf})
    for key in keys:
        fig, axes = _grid(n_env)
        any_line = False
        for r, e in enumerate(env_indices):
            for i in range(n_types):
                if key not in traj["agent_infos"][i]:
                    continue
                s = _per_env_series(traj["agent_infos"][i][key], e)
                if s is None:
                    continue
                for c in range(s.shape[1]):
                    axes[r, 0].plot(s[:, c], color=cmap(i),
                                    label=names[i] if c == 0 else None)
                    any_line = True
            axes[r, 0].set_title(f"env {e} {key}")
            axes[r, 0].grid(True, alpha=0.3)
            axes[r, 0].legend(frameon=False, fontsize=8)
        axes[-1, 0].set_xlabel("step")
        fig.tight_layout()
        if any_line:
            path = os.path.join(out_dir, f"info_{key}.png")
            fig.savefig(path, dpi=110)
            written.append(path)
        plt.close(fig)

    # ---- world features (price trajectories) ----------------------------
    world = traj.get("world_infos") or {}
    wkeys = [k for k in ("end_mid_price", "average_best_bid",
                         "average_best_ask") if k in world]
    wkeys += sorted(k for k in world
                    if k not in wkeys and _np(world[k]).ndim <= 2)
    if wkeys:
        fig, axes = _grid(n_env)
        for r, e in enumerate(env_indices):
            for k in wkeys[:6]:
                s = _per_env_series(world[k], e)
                if s is not None:
                    axes[r, 0].plot(s[:, 0], label=k)
            axes[r, 0].set_title(f"env {e} world")
            axes[r, 0].grid(True, alpha=0.3)
            axes[r, 0].legend(frameon=False, fontsize=8)
        axes[-1, 0].set_xlabel("step")
        fig.tight_layout()
        path = os.path.join(out_dir, "world.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)
    return written
