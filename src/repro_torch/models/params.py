"""Parameter schemas and their initialisation, as the model code reads them.

``ParamDef``, ``map_schema``, ``init_std`` and ``init_params`` are
defined where the reference defines them, in
``repro_torch.distributed.sharding``, which maps the leaves' logical axes
onto a mesh, and are re-exported here; ``stack_schema`` is the
reference's (``models/transformer.py``).  A schema is a nested dict of
``ParamDef``; ``init_params`` draws every leaf on one explicit
``torch.Generator`` in schema order, on the generator's device.

The init rule is the reference's, quirk included: ``fan_in`` is the
first dimension of the leaf's shape, taken AFTER ``stack_schema`` has
prepended the layer axis.  Every stacked "scaled" weight therefore has
std ``1/sqrt(num_layers)`` (0.158 at 40 layers), not ``1/sqrt(d_model)``.
That sets how large an untrained backbone's activations get, and the
port computes what the reference computes.

``ParamTree`` holds an initialised schema as an ``nn.Module`` whose
parameter names are the schema paths (``stack.layers.attn.wq``), and
indexes like a dict, so layer code reads ``p["attn"]["wq"]`` from a
tree or from a plain dict alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping

import torch
from torch import nn

from repro_torch.distributed.sharding import (ParamDef,  # noqa: F401
                                              init_params, init_std,
                                              map_schema)


def stack_schema(schema, n: int):
    """Add a leading layer axis of ``n`` (logical axis "layers") to every
    ParamDef."""
    return map_schema(lambda _, d: dataclasses.replace(
        d, shape=(n,) + tuple(d.shape),
        axes=None if d.axes is None else ("layers",) + tuple(d.axes)),
        schema)


class ParamTree(nn.Module):
    """A nested dict of tensors as frozen ``nn.Parameter``s."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def layer_slice(tree, i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree (every leaf indexed on axis 0)."""
    names = (list(tree._parameters) + list(tree._modules)
             if isinstance(tree, ParamTree) else list(tree))
    return {k: (layer_slice(tree[k], i) if isinstance(tree[k], (ParamTree, Mapping))
                else tree[k][i]) for k in names}


def layer_list(tree) -> List[Dict[str, Any]]:
    """Every layer of a stacked tree, as ``layer_slice`` gives them one at
    a time, from one ``unbind`` a leaf: under autograd the layers'
    gradients then meet in one stacked tensor, where a slice per layer
    would write a zero-filled stack per layer."""
    names = (list(tree._parameters) + list(tree._modules)
             if isinstance(tree, ParamTree) else list(tree))
    per = {k: (layer_list(tree[k]) if isinstance(tree[k], (ParamTree, Mapping))
               else torch.unbind(tree[k])) for k in names}
    n = len(next(iter(per.values())))
    return [{k: per[k][i] for k in names} for i in range(n)]


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (or ``ParamTree``s) -> {dotted path: leaf}, the
    ``state_dict()`` keys."""
    names = (list(tree._parameters) + list(tree._modules)
             if isinstance(tree, ParamTree) else list(tree))
    out: Dict[str, Any] = {}
    for k in names:
        path = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        out.update(flatten(v, path) if isinstance(v, (ParamTree, Mapping))
                   else {path: v})
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{dotted path: leaf} -> nested dicts."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
