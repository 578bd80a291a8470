"""Mesh configuration: data parallelism and a ``model`` axis.

Counterpart of ``vit_marl_tpu/parallel/mesh.py``.  In the JAX package
``MESH_SHAPE`` / ``MESH_AXES`` lay devices out on a mesh whose ``data``
axis and every ``*_data`` axis split the env batch (the DCN axis of
``make_hybrid_mesh`` between hosts, the ICI axes within one), and whose
``model`` axis splits the weights (``shard_params``).  In the port every
device of the mesh is a rank of the ``torch.distributed`` group, in the
mesh's row-major order (the JAX package's ``make_mesh`` reshapes its
device list the same way); ``parallel/distributed.py::mesh_groups`` cuts
the ranks into a data sub-group per model index and a model sub-group
per data index.

The ``model`` axis (tensor parallelism) follows ``shard_params``'s rule
as its code states it: a 2-D flax kernel ``(in, out)`` is split by
output where ``out`` divides by the axis's size, else by input where
``in`` does; every other leaf (biases, LayerNorm scales, the position
embedding and class token, which are 3-D, the CNN's 4-D kernels,
``log_std``) is replicated.  :func:`placement_plan` applies the rule to
the flax leaf that ``models/bridge.py`` maps each parameter from: a
``Linear`` weight is the kernel transposed, ``(out, in)``, and the GRU
cell's packed ``(3H, in)`` / ``(3H, H)`` weights are three flax kernels,
one a gate, so each gate's rows are split on their own
(:class:`Split` ``blocks=3``).  The rule covers the whole train state:
the Adam moments of a split leaf are split as it is
(``rl/ppo.py::PPOLearner``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

MODEL_AXIS = "model"


def data_axis_names(axes: Sequence[str]) -> Tuple[str, ...]:
    """The env-batch axes: ``data`` and every ``*_data`` axis."""
    return tuple(a for a in axes if a == "data" or str(a).endswith("_data"))


def model_axis_size(shape: Sequence[int], axes: Sequence[str]) -> int:
    """The size of the mesh's ``model`` axis (1 without one)."""
    return int(np.prod([n for n, a in zip(shape, axes) if a == MODEL_AXIS]))


def mesh_ranks(shape: Sequence[int], axes: Sequence[str]) -> int:
    """The ranks a mesh of ``shape`` over ``axes`` needs: the product of
    its data axes and its ``model`` axis."""
    data = set(data_axis_names(axes))
    return int(np.prod([n for n, a in zip(shape, axes) if a in data])) \
        * model_axis_size(shape, axes)


def wide_other_axes(shape: Sequence[int], axes: Sequence[str]):
    """The axes, other than the data axes and ``model``, that are wider
    than one device (the port has no other kind of parallelism)."""
    data = set(data_axis_names(axes))
    return {a: n for n, a in zip(shape, axes)
            if a not in data and a != MODEL_AXIS and n > 1}


def mesh_coords(rank: int, shape: Sequence[int], axes: Sequence[str]
                ) -> Tuple[int, int]:
    """(data index, model index) of ``rank`` on the row-major mesh: the
    data index ravels the data axes' coordinates in their order."""
    coords = np.unravel_index(rank, tuple(shape))
    data = set(data_axis_names(axes))
    d_shape = [n for n, a in zip(shape, axes) if a in data]
    d_coord = [c for c, a in zip(coords, axes) if a in data]
    m = [int(c) for c, a in zip(coords, axes) if a == MODEL_AXIS]
    d = int(np.ravel_multi_index(d_coord, d_shape)) if d_shape else 0
    return d, (m[0] if m else 0)


@dataclass(frozen=True)
class Split:
    """A split leaf's placement, in torch's ``(out, in)`` layout: ``dim``
    0 splits the output rows of each of ``blocks`` row blocks (the GRU's
    gates), 1 splits the input columns."""

    dim: int
    blocks: int = 1


def _gru_packed(module: nn.Module) -> Dict[nn.Module, int]:
    """The GRU cells' packed gate projections: module -> gates."""
    from vit_marl_tpu_torch.models.rnn import GRUCell

    out = {}
    for m in module.modules():
        if isinstance(m, GRUCell):
            out[m.w_i] = out[m.w_h] = 3
    return out


def placement_plan(net: nn.Module, n: int) -> Dict[str, Optional[Split]]:
    """Each parameter of ``net`` (``named_parameters`` order) over a
    ``model`` axis of ``n`` ranks: its :class:`Split`, or ``None`` where
    it is replicated (see the module docstring)."""
    packed = _gru_packed(net)
    plan: Dict[str, Optional[Split]] = {}
    for mname, mod in net.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            split = None
            if n > 1 and isinstance(mod, nn.Linear) and pname == "weight":
                blocks = packed.get(mod, 1)
                out, inp = p.shape[0] // blocks, p.shape[1]
                if out % n == 0:              # the flax kernel's output
                    split = Split(0, blocks)
                elif inp % n == 0:            # its input
                    split = Split(1)
            plan[name] = split
    return {k: plan[k] for k, _ in net.named_parameters()}


def shard(t: torch.Tensor, split: Split, rank: int, n: int) -> torch.Tensor:
    """``rank``'s block of a split leaf ``t`` (a view): ``(blocks, rows /
    n, in)`` by output, ``(out, in / n)`` by input."""
    if split.dim == 0:
        v = t.view((split.blocks, t.shape[0] // split.blocks)
                   + tuple(t.shape[1:]))
        k = v.shape[1] // n
        return v[:, rank * k:(rank + 1) * k]
    k = t.shape[1] // n
    return t[:, rank * k:(rank + 1) * k]


def join_shards(full: torch.Tensor, blocks: torch.Tensor,
                split: Split) -> torch.Tensor:
    """Write every rank's block, ``blocks`` ``(n, *shard shape)`` in rank
    order, into the whole leaf ``full`` (contiguous); returns ``full``."""
    n = blocks.shape[0]
    if split.dim == 0:
        b, k = blocks.shape[1], blocks.shape[2]
        full.view((b, n, k) + tuple(full.shape[1:])).copy_(
            blocks.transpose(0, 1))
    else:
        full.view(full.shape[0], n, blocks.shape[2]).copy_(
            blocks.transpose(0, 1))
    return full
