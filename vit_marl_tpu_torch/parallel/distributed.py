"""Data and model parallelism over ``torch.distributed``: one process a
device.

Counterpart of ``vit_marl_tpu/parallel/distributed.py`` and of the
collectives GSPMD derives in the JAX package's mesh training.  Each
data rank steps its own share of the env batch; the PPO update
all-reduces sums, counts and gradients over the data ranks so that every
rank takes the same optimizer step (``rl/ppo.py::PPOLearner``).  Under a
``model`` axis the ranks form a ``data x model`` grid
(:func:`mesh_groups`): the model ranks of one data index step the same
envs, and each stores its share of the split weights and their Adam
moments (``parallel/mesh.py``).  NCCL on cards, gloo on the CPU; gloo
also joins processes that share one card (NCCL will not put two ranks
on one card), and then carries CUDA tensors itself.

- :func:`initialize_distributed` joins the group that ``torchrun`` (or a
  launcher setting ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``) describes; with one process and nothing to join it
  does nothing, as the JAX package's does;
- :class:`DataGroup` is what the trainer holds: its rank, the number of
  ranks and the process group, with the few collectives the trainer
  makes, and under a ``model`` axis its model sub-group (``model``, a
  :class:`DataGroup` of the ranks that share its data index).
  ``DataGroup()`` is one process with no group, whose collectives are
  no-ops; a group of one rank (a 1-rank NCCL group) still runs every
  collective;
- :func:`run_group` starts ``world`` CPU processes on a free local port
  in a gloo group, runs a function in each, and returns their results,
  within a deadline (``graft_entry.py::dryrun_multichip`` and the tests
  use it).

    torchrun --nproc-per-node 8 -m vit_marl_tpu_torch.train \\
        --config configs/mesh_ippo_2player.yaml
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from vit_marl_tpu_torch.utils.tree import tree_map

# the longest a collective (or the group's rendezvous) waits for a peer
TIMEOUT_S = 300.0


def initialize_distributed() -> None:
    """``init_process_group`` from the launcher's environment (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), with
    :data:`TIMEOUT_S`; NCCL with a card, else gloo, each rank on the card
    ``LOCAL_RANK`` names.  Does nothing when a group exists already, or
    with no ``WORLD_SIZE`` or a ``WORLD_SIZE`` of 1 (one process, nothing
    to join)."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


class DataGroup:
    """A rank's place in the data-parallel group, and its collectives.

    ``DataGroup()``: one process, no group; every collective returns its
    input.  ``DataGroup.current()``: the default process group where one
    is initialized.  ``model``: the rank's model sub-group under a
    ``model`` axis wider than one (:func:`mesh_groups`), else ``None``."""

    def __init__(self, rank: int = 0, world: int = 1, group=None,
                 model: Optional["DataGroup"] = None):
        self.rank, self.world, self.group = rank, world, group
        self.model = model

    @property
    def writer(self) -> bool:
        """The one rank that logs and writes checkpoints: data rank 0 and,
        under a model axis, model rank 0."""
        return self.rank == 0 and (self.model is None or self.model.rank == 0)

    @classmethod
    def current(cls) -> "DataGroup":
        if not dist.is_initialized():
            return cls()
        return cls(dist.get_rank(), dist.get_world_size(),
                   dist.group.WORLD)

    @property
    def distributed(self) -> bool:
        """A process group exists (of one rank or more)."""
        return self.group is not None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place; returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of the group's rank ``src``, on every rank, in place."""
        if self.distributed:
            dist.broadcast(t, dist.get_global_rank(self.group, src),
                           group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(world, *t.shape)``: every rank's ``t`` in rank order."""
        if not self.distributed:
            return t[None].clone()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def mean_tensors(self, ts: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Each tensor's mean over ranks, in one all-reduce of their
        float32 concatenation.  The mean over ranks of per-rank means over
        equal counts is the mean over the whole batch."""
        if not self.distributed or not ts:
            return list(ts)
        flat = torch.cat([t.reshape(-1).float() for t in ts])
        self.all_reduce(flat).div_(self.world)
        out, off = [], 0
        for t in ts:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out

    def local_count(self, n: int) -> int:
        """This rank's share of ``n`` envs; raises where ``n`` does not
        split evenly (as ``parallel/mesh.py::shard_batch`` refuses)."""
        if n % self.world:
            raise ValueError(
                f"NUM_ENVS={n} is not divisible by the {self.world} data "
                "ranks: every rank steps an equal share of the envs")
        return n // self.world


def mesh_groups(base: DataGroup, shape: Sequence[int],
                axes: Sequence[str]) -> DataGroup:
    """Cut ``base`` (every rank of the mesh, in the mesh's row-major
    order) into the ``data x model`` grid of a mesh with a ``model`` axis
    wider than one: returns this rank's data sub-group (the ranks of its
    model index; its rank is the data index) with ``model``, its model
    sub-group (the ranks of its data index).  Every rank builds every
    sub-group, in one order, as ``new_group`` asks.  Without such an axis
    ``base`` is returned."""
    from vit_marl_tpu_torch.parallel.mesh import mesh_coords, model_axis_size

    m = model_axis_size(shape, axes)
    if m <= 1:
        return base
    coords = [mesh_coords(r, shape, axes) for r in range(base.world)]
    n_data = base.world // m
    mine = coords[base.rank]
    data_g = model_g = None
    for k in range(m):
        g = dist.new_group([r for r, c in enumerate(coords) if c[1] == k])
        if k == mine[1]:
            data_g = g
    for d in range(n_data):
        g = dist.new_group([r for r, c in enumerate(coords) if c[0] == d])
        if d == mine[0]:
            model_g = g
    model = DataGroup(mine[1], m, model_g)
    return DataGroup(mine[0], n_data, data_g, model=model)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, fn, args, results,
           timeout_s: float) -> None:
    torch.set_num_threads(1)            # the CPU is shared by the ranks
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(DataGroup.current(), *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor would travel as a handle on this process's
        # shared memory, which ends with it
        results.put((rank, True, tree_map(
            lambda v: v.detach().cpu().numpy()
            if isinstance(v, torch.Tensor) else v, out)))
    except BaseException:           # reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def run_group(fn: Callable, world: int, args: Sequence[Any] = (),
              deadline_s: float = 120.0) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new CPU processes joined in a
    gloo group on a free local port; returns their results by rank, every
    tensor in them as a numpy array.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  Every
    collective and the rendezvous time out after ``deadline_s``; the
    parent waits for the results until ``deadline_s`` has passed, then
    joins the children, kills any still alive, and raises
    ``RuntimeError`` if a child failed or did not finish."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, world, port, fn, tuple(args),
                                              results, deadline_s),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(
                    timeout=max(end - time.monotonic(), 0.01))
            except queue_mod.Empty:
                errors.append(f"no result within {deadline_s}s from ranks "
                              f"{sorted(set(range(world)) - set(got))}")
                break
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank} failed:\n{out}")
        for p in procs:
            p.join(max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    if errors:
        raise RuntimeError("run_group: " + "\n".join(errors))
    return [got[r] for r in range(world)]
