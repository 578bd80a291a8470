"""Local grid-sweep runner (port of ``vit_marl_tpu/rl/sweep.py``; replaces
the reference's wandb grid sweeps, ref: gymnax_exchange/jaxrl/MARL/
ippo_rnn_JAXMARL.py:952-993).

A sweep spec maps dotted config keys to lists of values; the runner trains
every combination with the port's trainer and writes one JSONL row per run
with its final metrics, as the JAX package does.

Example::

    from vit_marl_tpu_torch.rl.sweep import run_sweep
    run_sweep(base_raw_config, {
        "LR": [1e-4, 2.5e-4],
        "AGENT_CONFIGS.MarketMaking.REWARD_SPACE": ["buy_sell_pnl", "spooner"],
    }, out_path="sweep_results.jsonl")
"""

from __future__ import annotations

import copy
import itertools
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from vit_marl_tpu_torch.config import make_config
from vit_marl_tpu_torch.rl.ppo import make_train


def _set_dotted(raw: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = raw
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def split_sweep(raw: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                              Dict[str, List[Any]]]:
    """``(base, grid)`` of a run config with a ``SWEEP:`` section: the
    section popped (ref: ``vit_marl_tpu/rl/sweep.py::main``), a scalar
    value read as a list of one.  Raises ``ValueError`` without one."""
    raw = dict(raw)
    grid = raw.pop("SWEEP", None)
    if not grid:
        raise ValueError("the config has no SWEEP: section")
    return raw, {k: (v if isinstance(v, list) else [v])
                 for k, v in grid.items()}


def _train(base_raw, overrides, seed, device):
    raw = copy.deepcopy(base_raw)
    for k, v in overrides.items():
        _set_dotted(raw, k, v)
    ma_config, train_config = make_config(raw)
    return make_train(ma_config, train_config, device=device)(seed)


def run_sweep(base_raw: Dict[str, Any], grid: Dict[str, List[Any]],
              out_path: Optional[str] = None, seed: int = 0,
              device=None) -> List[Dict]:
    """Train every combination of ``grid`` over ``base_raw`` on ``device``
    (the card unless ``device="cpu"``); returns and appends to
    ``out_path`` one row a run: its overrides, wall seconds and last
    update's metrics."""
    keys = list(grid)
    results = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        t0 = time.time()
        out = _train(base_raw, overrides, seed, device)
        row = {
            "overrides": overrides,
            "wall_seconds": round(time.time() - t0, 2),
            "final_metrics": {k: float(v)
                              for k, v in out["metrics"][-1].items()},
        }
        results.append(row)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        print(f"sweep {overrides}: done in {row['wall_seconds']}s",
              flush=True)
    return results


# --------------------------------------------------------------------------
# wandb sweep-service orchestration (ref: ippo_rnn_JAXMARL.py:952-993)
# --------------------------------------------------------------------------

def grid_to_wandb_sweep(grid: Dict[str, List[Any]],
                        method: str = "grid") -> Dict[str, Any]:
    """Translate a dotted-key grid into a wandb sweep config: dotted
    segments become nested ``{"parameters": {...}}`` levels, leaves
    ``{"values": [...]}`` (ref: ippo_rnn_JAXMARL.py:952-984)."""
    parameters: Dict[str, Any] = {}
    for key, values in grid.items():
        node = parameters
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {}).setdefault("parameters", {})
        node[parts[-1]] = {"values": list(values)}
    return {"method": method, "parameters": parameters}


def _flatten_wandb_config(node: Any, prefix: str = "") -> Dict[str, Any]:
    """wandb hands the agent a (possibly nested) config mapping; flatten it
    back to dotted override keys."""
    out: Dict[str, Any] = {}
    if hasattr(node, "items"):
        for k, v in node.items():
            if k.startswith("_"):        # wandb bookkeeping keys
                continue
            key = f"{prefix}.{k}" if prefix else str(k)
            if hasattr(v, "items"):
                out.update(_flatten_wandb_config(v, key))
            else:
                out[key] = v
    return out


def run_wandb_sweep(base_raw: Dict[str, Any], grid: Dict[str, List[Any]],
                    project: str = "vit-marl-tpu",
                    entity: Optional[str] = None, count: int = 500,
                    method: str = "grid", seed: int = 0,
                    device=None) -> str:
    """Register the grid with the wandb sweep service and run the agent
    loop (ref: ippo_rnn_JAXMARL.py:989-993 ``wandb.sweep``/``wandb.agent``).

    Each agent trial applies the service-assigned overrides to the base
    config and runs one training.  Needs the ``wandb`` package and the
    service; :func:`run_sweep` is the offline local grid.  Returns the
    sweep id.
    """
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(
            "run_wandb_sweep needs the wandb package; use run_sweep for "
            "the offline local grid") from e

    def trial():
        run = wandb.init()
        out = _train(base_raw, _flatten_wandb_config(run.config), seed,
                     device)
        wandb.log({k: float(v) for k, v in out["metrics"][-1].items()})
        run.finish()

    sweep_id = wandb.sweep(sweep=grid_to_wandb_sweep(grid, method),
                           project=project, entity=entity)
    wandb.agent(sweep_id, function=trial, count=count)
    return sweep_id


def main(argv=None):
    """File-driven sweep CLI (the reference's fine-sweep workflow,
    ref: config/ippo_rnn_JAXMARL_fine_sweep.yaml): a run YAML whose
    ``SWEEP:`` section maps dotted config keys to value lists; every other
    key is the base config.

      python -m vit_marl_tpu_torch.rl.sweep --config configs/sweep_fine.yaml
      python -m vit_marl_tpu_torch.rl.sweep --config ... --device cpu
      python -m vit_marl_tpu_torch.rl.sweep --config ... --wandb
    """
    import argparse

    import yaml

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True,
                   help="YAML with a SWEEP: {dotted.key: [values]} section")
    p.add_argument("--out", default="sweep_results.jsonl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--wandb", action="store_true",
                   help="register with the wandb sweep service and run "
                        "wandb.agent instead of the offline local grid")
    args = p.parse_args(argv)

    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    try:
        base, grid = split_sweep(raw)
    except ValueError:
        raise SystemExit(f"{args.config} has no SWEEP: section") from None
    if args.wandb:
        run_wandb_sweep(base, grid, seed=args.seed, device=args.device)
    else:
        run_sweep(base, grid, out_path=args.out, seed=args.seed,
                  device=args.device)


if __name__ == "__main__":
    main()
