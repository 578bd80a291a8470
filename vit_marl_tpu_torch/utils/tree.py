"""Tree helpers over the port's state containers.

The JAX package maps functions over pytrees (``jax.tree.map``,
``utils/tree.py::index_tree``).  The port's states are dataclasses, tuples,
lists and dicts of tensors; :func:`tree_map` walks the same structures.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise to ``tree`` and the same-shaped ``rest``.

    ``None`` leaves stay ``None``.
    """
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):   # NamedTuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in :func:`tree_map`'s order (no ``None``)."""
    out = []

    def take(leaf):
        out.append(leaf)
        return leaf

    tree_map(take, tree)
    return out


def index_tree(tree, index):
    """Gather ``leaf[index]`` from every leaf: the reset-table gather
    (ref: ``vit_marl_tpu/utils/tree.py::index_tree``)."""
    return tree_map(lambda leaf: leaf[index], tree)


def tree_stack(trees):
    """Stack a list of identically-shaped trees along a new leading axis
    (ref: ``vit_marl_tpu/utils/tree.py::tree_stack``)."""
    return tree_map(lambda *v: torch.stack(v), trees[0], *trees[1:])


def tree_unstack(tree):
    """Inverse of :func:`tree_stack`: the list of trees along the leading
    axis."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda leaf, i=i: leaf[i], tree) for i in range(n)]
