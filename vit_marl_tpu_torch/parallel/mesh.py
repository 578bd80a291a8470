"""Mesh configuration for data-parallel training.

Counterpart of ``vit_marl_tpu/parallel/mesh.py``.  In the JAX package
``MESH_SHAPE`` / ``MESH_AXES`` lay devices out on a mesh whose ``data``
axis and every ``*_data`` axis split the env batch (the DCN axis of
``make_hybrid_mesh`` between hosts, the ICI axes within one); in the port
each data position is a rank of the ``torch.distributed`` group, so the
product of the data axes is the number of ranks, between hosts or within
one.  A ``model`` axis of more than one device (the JAX package's
tensor parallelism, ``shard_params``) is not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def data_axis_names(axes: Sequence[str]) -> Tuple[str, ...]:
    """The env-batch axes: ``data`` and every ``*_data`` axis."""
    return tuple(a for a in axes if a == "data" or str(a).endswith("_data"))


def mesh_ranks(shape: Sequence[int], axes: Sequence[str]) -> int:
    """The ranks a mesh of ``shape`` over ``axes`` needs: the product of
    its data axes."""
    data = set(data_axis_names(axes))
    return int(np.prod([n for n, a in zip(shape, axes) if a in data]))


def wide_other_axes(shape: Sequence[int], axes: Sequence[str]):
    """The axes other than the data axes that are wider than one device
    (a ``model`` axis: tensor parallelism, not ported)."""
    data = set(data_axis_names(axes))
    return {a: n for n, a in zip(shape, axes) if a not in data and n > 1}
