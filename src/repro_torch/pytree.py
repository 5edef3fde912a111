"""Trees of tensors: the dict / list / tuple nests that replicate
functions, executors, the runtime and the model code map over.

A leaf module: it imports nothing of ``repro_torch``, so any layer can
use it.  ``repro_torch.inference.executor`` re-exports every name.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

Tensor = torch.Tensor


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a dict / list / tuple tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leading_dim(xs: Any) -> int:
    """The replicate axis' length (every tensor leaf shares it)."""
    leaves = [x for x in tree_leaves(xs) if isinstance(x, Tensor)]
    if not leaves:
        raise ValueError("a map needs at least one tensor input")
    b = leaves[0].shape[0]
    if any(x.shape[0] != b for x in leaves):
        raise ValueError("every leaf of a mapped input must share its "
                         f"leading axis, got {[tuple(x.shape) for x in leaves]}")
    return b


def slice_tree(xs: Any, lo: int, hi: int) -> Any:
    """Replicates [lo, hi) of every leaf."""
    return tree_map(lambda x: x[lo:hi], xs)


def concat_trees(outs: List[Any]) -> Any:
    """Leafwise concatenation along the replicate axis, in order."""
    if len(outs) == 1:
        return outs[0]
    return tree_map(lambda *ys: torch.cat(ys), outs[0], *outs[1:])
