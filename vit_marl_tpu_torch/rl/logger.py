"""Metric logging behind a thin interface.

Port of ``vit_marl_tpu/rl/logger.py``: the trainer hands each update's
metrics to a backend, ``print``, ``jsonl`` (one JSON object a line,
appended to ``path``), ``wandb`` (only where ``import wandb`` works; else
``jsonl``, as in the JAX package) or ``none``.  Values become Python
numbers where they hold one element and lists otherwise, so a jsonl line
is the JAX logger's line for the same metrics.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch


def _host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    return a.item() if a.size == 1 else a.tolist()


class Logger:
    def __init__(self, backend: str = "print", path: str = "metrics.jsonl"):
        self.backend = backend
        self.path = path
        self._wandb = None
        if backend == "wandb":
            try:
                import wandb
                self._wandb = wandb
            except ImportError:
                self.backend = "jsonl"

    def log(self, metrics: Dict[str, Any]) -> None:
        metrics = {k: _host(v) for k, v in metrics.items()}
        if self.backend == "print":
            step = metrics.get("update_step", "?")
            keys = [k for k in sorted(metrics) if k != "update_step"][:8]
            line = " ".join(f"{k}={metrics[k]:.4g}" for k in keys
                            if isinstance(metrics[k], float))
            print(f"[update {step}] {line}", flush=True)
        elif self.backend == "jsonl":
            with open(self.path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
        elif self.backend == "wandb" and self._wandb is not None:
            self._wandb.log(metrics)
