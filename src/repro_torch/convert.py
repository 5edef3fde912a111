"""Carry state from the JAX package into the port's tensors.

torch cannot replay the JAX package's random streams, so parity runs hand the
reference's random draws (data, fold ids, model weights) and results
(nuisance fold states, theta, cov) to the port.  Everything here takes numpy arrays —
``np.asarray`` of a JAX array — never a JAX object, so the port imports
nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import map_schema

Tensor = torch.Tensor


def _f32(a, dev) -> Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)


def data(X, y, t, *, device: DeviceLike = None
         ) -> Tuple[Tensor, Tensor, Tensor]:
    """(X (n, p), y (n,), t (n,)) as fp32 tensors."""
    dev = resolve_device(device)
    return _f32(X, dev), _f32(y, dev), _f32(t, dev)


def folds(f, *, device: DeviceLike = None) -> Tensor:
    """Fold ids (``DMLResult.crossfit.folds``) as an int64 tensor."""
    dev = resolve_device(device)
    return torch.as_tensor(np.asarray(f).astype(np.int64), device=dev)


def fold_states(states: Mapping[str, np.ndarray], *,
                device: DeviceLike = None) -> Dict[str, Tensor]:
    """Nuisance fold states ``{"beta": (k, q), "lam": (k,)}`` stacked per
    fold, as fp32 tensors."""
    dev = resolve_device(device)
    return {key: _f32(states[key], dev) for key in ("beta", "lam")}


def mlp_state(np_state: Mapping[str, Any], *,
              device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's mlp nuisance state — ``{"params": {"w0", "b0",
    ...}, "opt": AdamWState}`` from its ``init`` (``_mlp_init``'s draws),
    with numpy leaves and any leading batch axes — as the port's
    ``make_mlp`` state.  The optimizer state comes across too; without
    one it starts at 0."""
    from repro_torch.optim.adamw import adamw_init

    dev = resolve_device(device)
    params = {key: _f32(v, dev) for key, v in np_state["params"].items()}
    opt = np_state.get("opt")
    if opt is None:
        lead = params["w0"].dim() - 2
        return {"params": params, "opt": adamw_init(params, batch_dims=lead)}

    return {"params": params, "opt": {
        "step": torch.as_tensor(np.array(opt.step, dtype=np.int32),
                                device=dev),
        "m": {key: _f32(v, dev) for key, v in opt.m.items()},
        "v": {key: _f32(v, dev) for key, v in opt.v.items()}}}


def theta_cov(theta, cov, *, device: DeviceLike = None
              ) -> Tuple[Tensor, Tensor]:
    """(theta (p_phi,), cov (p_phi, p_phi)) as fp32 tensors."""
    dev = resolve_device(device)
    return _f32(theta, dev), _f32(cov, dev)


def model_params(cfg, tree: Mapping[str, Any], *,
                 device: DeviceLike = None) -> Dict[str, Tensor]:
    """The reference's ``Model.init`` pytree (nested dicts of arrays,
    stacked ``(L, ...)`` per layer; moe's ``dense_layers`` /
    ``moe_layers`` with their ``moe.shared`` / ``moe.dense`` sub-trees,
    MLA's weights and the encoder-decoder's ``encoder`` / ``decoder``
    trees too) -> the port's ``Model`` state_dict
    (dotted schema paths, fp32 tensors).  Every path and shape is checked
    against the port's schema for ``cfg``."""
    dev = resolve_device(device)
    want: Dict[str, tuple] = {}

    def note(path, d):
        want[path] = tuple(d.shape)

    map_schema(note, Model.schema_of(cfg))
    got: Dict[str, Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        else:
            got[path] = _f32(node, dev)

    walk(tree, "")
    if set(got) != set(want):
        raise ValueError(f"model_params: paths differ from the schema: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}")
    for path, x in got.items():
        if tuple(x.shape) != want[path]:
            raise ValueError(f"model_params: {path} has shape "
                             f"{tuple(x.shape)}, the schema {want[path]}")
    return got


def adamw_state(np_state, *, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's ``AdamWState`` of an LM (``step`` and the moments
    ``m`` / ``v`` as nested dicts like its params, numpy leaves) -> the
    port's AdamW state {"step": int32, "m", "v": {dotted path: fp32}},
    leaf for leaf under ``model_params``' names."""
    dev = resolve_device(device)
    return {"step": torch.as_tensor(np.array(np_state.step, dtype=np.int32),
                                    device=dev),
            "m": {k: _f32(v, dev) for k, v in _flatten(np_state.m).items()},
            "v": {k: _f32(v, dev) for k, v in _flatten(np_state.v).items()}}


def _leaf(a, dtype: torch.dtype, dev) -> Tensor:
    """A numpy leaf (bfloat16 included: ml_dtypes' arrays go through fp32,
    exactly) as a tensor of ``dtype``."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.as_tensor(np.array(arr), device=dev).to(dtype)


def _flatten(tree: Mapping[str, Any], path: str = "") -> Dict[str, Any]:
    """Nested dicts -> {dotted path: leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        sub = f"{path}.{k}" if path else k
        out.update(_flatten(v, sub) if isinstance(v, Mapping) else {sub: v})
    return out


def cache(cfg, np_tree: Mapping[str, Any], *,
          device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's serving cache (``Model.prefill`` / ``init_cache``
    output, nested dicts with numpy leaves: moe's {"dense", "moe"},
    MLA's {"c_kv", "k_rope"} and the encoder-decoder's {"self",
    "cross"} too) -> the port's cache for ``Model.decode_step``.  The
    layouts are the same leaf for leaf (stacked on the layer axis); every
    path and shape is checked against the port's ``init_cache`` at the
    tree's batch and sequence length (an encoder-decoder's cross half at
    its own source length), and each leaf takes that cache's dtype."""
    from repro_torch.config import ParallelConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import DecoderStack

    dev = resolve_device(device)
    flat = _flatten(np_tree)
    batch = np.shape(next(iter(flat.values())))[1]

    def seq_of(prefix=""):
        seq = [np.shape(a)[2] for p, a in flat.items() if p.startswith(prefix)
               and p.split(".")[-1] in ("k", "c_kv")]
        return seq[0] if seq else 1

    if cfg.is_encdec:
        want = _flatten({part: attn.init_cache(
            cfg, batch, seq_of(part + "."), cfg.num_layers, device="meta")
            for part in ("self", "cross")})
    else:
        want = _flatten(DecoderStack(cfg, ParallelConfig()).init_cache(
            batch, seq_of(), device="meta"))
    if set(flat) != set(want):
        raise ValueError(f"cache: paths differ from the port's layout: "
                         f"missing {sorted(set(want) - set(flat))}, "
                         f"extra {sorted(set(flat) - set(want))}")
    out: Dict[str, Any] = {}
    for path, a in flat.items():
        if tuple(np.shape(a)) != tuple(want[path].shape):
            raise ValueError(f"cache: {path} has shape {tuple(np.shape(a))}, "
                             f"the port's {tuple(want[path].shape)}")
        node = out
        *head, name = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[name] = _leaf(a, want[path].dtype, dev)
    return out


def store_state(np_state: Mapping[str, np.ndarray], *,
                device: DeviceLike = None) -> Dict[str, Tensor]:
    """One store column's accumulators — the reference's
    ``{"ng", "vg", "counts"}`` (``store.stats.init_state`` layout) — as
    fp32 tensors, for ``store.solve.refresh_column``."""
    dev = resolve_device(device)
    return {key: _f32(np_state[key], dev) for key in ("ng", "vg", "counts")}


def serving_panel(np_thetas, np_ses, np_ok, *, n_features: int,
                  version: int = 0, column: str = "",
                  device: DeviceLike = None):
    """The reference's ``ServingPanel`` arrays — thetas (E, pf), ses
    (E, pf), ok (E,) — as the port's ``ServingPanel`` on ``device``, so
    both packages can score the same panel."""
    from repro_torch.serve_effects.panel import ServingPanel

    dev = resolve_device(device)
    thetas = _f32(np_thetas, dev)
    return ServingPanel(thetas=thetas, ses=_f32(np_ses, dev),
                        ok=torch.as_tensor(np.asarray(np_ok, dtype=bool),
                                           device=dev),
                        n_features=int(n_features),
                        cate_features=int(thetas.shape[1]),
                        version=int(version), column=column)
