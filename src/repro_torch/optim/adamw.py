"""AdamW with decoupled weight decay and global-norm clipping, as plain
functions on dicts of tensors (the JAX package's ``optim.adamw``).

The math runs in fp32 whatever the parameter and moment dtypes.  Two
points where it is not ``torch.optim.AdamW``:

  * the weight decay is added into the step's ``delta`` on the
    pre-step parameter, ``p - lr·(m̂/(√v̂ + 1e-8) + wd·p)``, not applied
    as a separate ``p·(1 - lr·wd)``;
  * ``b2`` defaults to 0.95 (``TrainConfig``), not 0.999.

A dict may hold a *batch* of models: every leaf carries the same
``batch_dims`` leading axes (the fold, trial or replicate axis of the
mlp nuisance's batched fit).  Each model then has its own step count,
its own global norm — over that model's leaves only, never over the
batch — and may have its own learning rate.  Each model's norm is
reduced alone, so a model's numbers do not depend on the batch it sits
in.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.distributed.sharding import like

Tensor = torch.Tensor
Params = Dict[str, Tensor]
_F32 = torch.float32


def _bcast(v: Tensor, leaf: Tensor, batch_dims: int) -> Tensor:
    """A per-model value (batch shape, or a scalar) broadcast against
    ``leaf``'s trailing axes."""
    if v.dim() == 0:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (leaf.dim() - batch_dims))


def adamw_init(params: Params, moment_dtype=_F32, batch_dims: int = 0
               ) -> Dict[str, object]:
    """Zero moments and a zero step count (one per model of the batch)."""
    zeros = {key: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for key, p in params.items()}
    leaf = next(iter(params.values()))
    return {"step": torch.zeros(leaf.shape[:batch_dims], dtype=torch.int32,
                                device=leaf.device),
            "m": zeros, "v": {key: z.clone() for key, z in zeros.items()}}


def global_norm(tree: Params, batch_dims: int = 0) -> Tensor:
    """sqrt(Σ_leaves Σ x²) per model: a scalar, or the batch shape.
    Each model's sums are reduced on that model's leaf alone."""
    total = None
    for x in tree.values():
        x32 = x.to(_F32)
        if batch_dims == 0:
            s = torch.sum(torch.square(x32))
        else:
            flat = x32.reshape((-1,) + tuple(x32.shape[batch_dims:]))
            s = torch.stack([torch.sum(torch.square(m)) for m in flat]
                            ).reshape(x32.shape[:batch_dims])
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float, batch_dims: int = 0
                        ) -> Tuple[Params, Tensor]:
    """Scale each model's gradients to a global norm of at most
    ``max_norm``; returns (clipped grads, per-model norm)."""
    norm = global_norm(grads, batch_dims)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ({key: (g.to(_F32) * _bcast(scale, g, batch_dims)).to(g.dtype)
             for key, g in grads.items()}, norm)


def _adam_leaf(g32: Tensor, m: Tensor, v: Tensor, p: Tensor, c1: Tensor,
               c2: Tensor, lr_t: Tensor, cfg: TrainConfig, batch_dims: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """One leaf's (new p in fp32, new m, new v in fp32)."""
    m32 = cfg.b1 * m.to(_F32) + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.to(_F32) + (1 - cfg.b2) * torch.square(g32)
    mhat = m32 / _bcast(c1, p, batch_dims)
    vhat = v32 / _bcast(c2, p, batch_dims)
    p32 = p.to(_F32)
    delta = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay * p32
    return p32 - _bcast(lr_t, p, batch_dims) * delta, m32, v32


def _step_terms(state, lr, cfg: TrainConfig):
    """(step + 1, the bias corrections c1, c2, lr as an fp32 tensor).
    The corrections 1 - b^step are taken in fp64 and rounded once to
    fp32: a vectorized and a scalar fp32 pow may part by an ulp, and
    which one runs depends on the batch's size."""
    step = state["step"] + 1
    step64 = step.to(torch.float64)
    c1 = (1.0 - torch.pow(cfg.b1, step64)).to(_F32)
    c2 = (1.0 - torch.pow(cfg.b2, step64)).to(_F32)
    return step, c1, c2, torch.as_tensor(lr, dtype=_F32, device=step.device)


def adamw_update(grads: Params, state: Dict[str, object], params: Params,
                 lr, cfg: TrainConfig, moment_dtype=_F32,
                 batch_dims: int = 0):
    """One decoupled-weight-decay Adam step; returns (new params, new
    state, metrics).  ``lr`` is a float, a scalar tensor, or a tensor of
    the batch shape (one rate per model)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, batch_dims)
    step, c1, c2, lr_t = _step_terms(state, lr, cfg)
    new_p, new_m, new_v = {}, {}, {}
    for key, p in params.items():
        p32, m32, v32 = _adam_leaf(grads[key].to(_F32), state["m"][key],
                                   state["v"][key], p, c1, c2, lr_t, cfg,
                                   batch_dims)
        new_p[key] = p32.to(p.dtype)
        new_m[key] = m32.to(moment_dtype)
        new_v[key] = v32.to(moment_dtype)
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return new_p, {"step": step, "m": new_m, "v": new_v}, metrics


def adamw_update_(grads: Params, state: Dict[str, object], params: Params,
                  lr, cfg: TrainConfig):
    """``adamw_update`` of one model (no batch axes) IN PLACE, leaf by
    leaf, with the same arithmetic and so the same bits: ``params`` and
    the state's moments are overwritten (in their own dtypes) and the
    state's step replaced, and ``grads`` is consumed (each leaf popped
    as it is used).  LM training takes it, as the reference donates its
    params and optimizer state to the jitted step: the step then needs
    no second copy of the weights and moments, only one leaf's
    temporaries.  Returns (params, state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step, c1, c2, lr_t = _step_terms(state, lr, cfg)
    for key, p in params.items():
        g = grads.pop(key)
        g32 = (g.to(_F32) * scale).to(g.dtype).to(_F32)
        del g
        m, v = state["m"][key], state["v"][key]
        p32, m32, v32 = _adam_leaf(g32, m, v, p, c1, c2, lr_t, cfg, 0)
        del g32
        p.copy_(like(p32, p))
        m.copy_(like(m32, m))
        v.copy_(like(v32, v))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
