"""Checkpoints of a training run, one directory per saved update.

Counterpart of ``vit_marl_tpu/rl/checkpoint.py`` in the port's own format
(the JAX package writes orbax trees; the two formats do not cross-load):
``{directory}/{step}/state.pt``, a ``torch.save`` of plain dicts and lists
of CPU tensors, ints and floats, loadable with
``torch.load(weights_only=True)``:

- ``params``: each agent type's ``state_dict``;
- ``opt``: each type's Adam moments and step counts, a list per parameter
  in ``net.parameters()`` order (``exp_avg``, ``exp_avg_sq``, ``step``);
- ``count``: each type's optimizer steps taken (the schedule count);
- ``metrics``: the update's metrics as floats.

A step's directory is written under a temporary name and renamed into
place, so a run killed mid-save leaves the previous checkpoints whole.
The ``max_to_keep`` most recent steps are kept, and with ``keep_period``
every step that is a multiple of it besides, as orbax does.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch

FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2,
                 keep_period: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self._closed = False

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params_list, opt_states, train_steps,
             metrics: Optional[Dict] = None) -> str:
        """Save per-type ``state_dict``s, the Adam states of
        :func:`adam_state` and the optimizer step counts; returns the
        step's directory.  Raises ``RuntimeError`` after :meth:`close`."""
        if self._closed:
            raise RuntimeError(f"checkpoint manager of {self.directory} is "
                               "closed")
        payload = {"params": [{k: v.detach().cpu() for k, v in p.items()}
                              for p in params_list],
                   "opt": [{k: [t.detach().cpu() for t in ts]
                            for k, ts in s.items()} for s in opt_states],
                   "count": [int(c) for c in train_steps]}
        if metrics is not None:
            payload["metrics"] = {k: float(v) for k, v in metrics.items()}
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()
        return final

    def _prune(self) -> None:
        """Delete every step but the ``max_to_keep`` most recent and, with
        ``keep_period``, its multiples (orbax's ``LatestN`` and
        ``EveryNSteps`` preservation policies)."""
        steps = self.all_steps()
        for s in steps[:max(len(steps) - self.max_to_keep, 0)]:
            if self.keep_period is None or s % self.keep_period:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def close(self) -> None:
        """End saving: :meth:`save` writes before it returns, so nothing
        is waited for; a later :meth:`save` raises.  Idempotent."""
        self._closed = True

    def restore(self, step: Optional[int] = None) -> Dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), FILE),
                          map_location="cpu", weights_only=True)


def adam_state(opt: torch.optim.Adam) -> Dict[str, List[torch.Tensor]]:
    """The Adam moments and step counts of ``opt``'s parameters, in their
    order (zeros before the first step)."""
    out = {"exp_avg": [], "exp_avg_sq": [], "step": []}
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            out["exp_avg"].append(st.get("exp_avg", torch.zeros_like(p)))
            out["exp_avg_sq"].append(st.get("exp_avg_sq",
                                            torch.zeros_like(p)))
            out["step"].append(torch.as_tensor(
                st.get("step", 0.0), dtype=torch.float32).cpu())
    return out


def load_adam_state(opt: torch.optim.Adam, saved, label: str = "") -> None:
    """Put saved moments and step counts into ``opt``; raises
    ``ValueError`` where the parameters' number or shapes differ."""
    params = [p for g in opt.param_groups for p in g["params"]]
    if any(len(saved[k]) != len(params) for k in saved):
        raise ValueError(
            f"resume: optimizer structure changed since the checkpoint was "
            f"written{label}: {len(saved['exp_avg'])} saved parameters vs "
            f"{len(params)} live. Start fresh or match the original config.")
    for p, m, v, s in zip(params, saved["exp_avg"], saved["exp_avg_sq"],
                          saved["step"]):
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(
                f"resume: Adam moment shape {tuple(m.shape)} does not match "
                f"the live parameter's {tuple(p.shape)}{label}")
        opt.state[p] = {"step": s.detach().clone().float().cpu(),
                        "exp_avg": m.to(p.device, p.dtype).clone(),
                        "exp_avg_sq": v.to(p.device, p.dtype).clone()}
