"""Parameter schemas and their initialisation, without sharding.

The port's counterpart of the reference's ``ParamDef`` / ``init_params``
(``distributed/sharding.py``) and ``stack_schema``
(``models/transformer.py``); ``repro_torch.distributed.sharding`` maps
the leaves' logical axes onto a mesh.  A schema is a nested dict of ``ParamDef``;
``init_params`` draws every leaf on one explicit ``torch.Generator`` in
schema order, on the generator's device.

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
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + initializer.  The
    axes ("embed", "heads", "ff", ...) are what ``distributed.sharding``
    maps onto a mesh; every schema leaf names one per dimension."""

    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"  # normal | zeros | ones | scaled | embed
    scale: Optional[float] = None
    dtype: Any = None  # filled from ModelConfig.param_dtype if None


def map_schema(fn, schema, path: str = ""):
    """``fn(path, ParamDef)`` over every leaf, paths dotted."""
    if isinstance(schema, ParamDef):
        return fn(path, schema)
    if isinstance(schema, Mapping):
        return {k: map_schema(fn, v, f"{path}.{k}" if path else k)
                for k, v in schema.items()}
    raise TypeError(f"bad schema node at {path!r}: {type(schema)}")


def stack_schema(schema, n: int):
    """Add a leading layer axis of ``n`` (logical axis "layers") to every
    ParamDef."""
    return map_schema(lambda _, d: dataclasses.replace(
        d, shape=(n,) + tuple(d.shape),
        axes=None if d.axes is None else ("layers",) + tuple(d.axes)),
        schema)


def init_std(d: ParamDef) -> float:
    """The reference's std for a "normal" / "scaled" / "embed" leaf."""
    fan_in = d.shape[0] if len(d.shape) else 1
    if d.init == "scaled":
        return (d.scale if d.scale is not None else 1.0) / max(1.0, fan_in) ** 0.5
    return d.scale if d.scale is not None else 0.02


def init_params(gen: torch.Generator, schema,
                param_dtype=torch.float32) -> Dict[str, Any]:
    """Materialise a schema into a nested dict of tensors, drawn in
    schema order on ``gen`` (and on its device)."""
    dev = gen.device

    def make(_, d: ParamDef):
        dtype = d.dtype or param_dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(init_std(d)).to(dtype)

    return map_schema(make, schema)


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
