"""Elastic resume: of an LM train state, and of a sweep.

LM training (the reference's ``state_template`` / ``elastic_restore``):
``launch/train.train_loop`` saves {"params", "opt"} through a
``CheckpointManager``; ``elastic_restore(manager, model)`` rebuilds the
state's template from the model's schema (shapes and dtypes on the meta
device, no memory) and loads the latest (or a given) checkpoint onto a
device, with its meta (``meta["step"]``).  The checkpoint format holds
no placement, so a state saved on one device resumes on another, and a
state saved on one mesh resumes on another: ``elastic_restore(manager,
model, rules, mesh)`` places every leaf under the new mesh's
``state_shardings`` (the mesh may have another number of ranks than the
one that saved it); the data resumes from the saved step, since a batch
is a pure function of (seed, step).

Sweeps: run one with per-column checkpoints, and on
a re-run — after a lost shard, a killed process, or on another number
of ranks — restore every completed column from disk and recompute only
the rest.  This is the causal path's answer to Ray's recovery of the
tasks of a failed machine.

    panel = elastic_sweep(spec, directory="ckpt/", data_mesh=mesh,
                          X=X, y=y, t=t, segment_ids=sids)

A column's checkpoint is signed with its estimator, its config and the
grid's height, not with the mesh, so a sweep saved on N ranks resumes on
M.  Under a mesh every rank calls ``elastic_sweep`` alike with the same
``directory``, which all ranks must see; rank 0 writes it.

"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.model import Model
from repro_torch.models.params import flatten, map_schema


def state_template(model: Model) -> Dict[str, Any]:
    """The train state's template, matching ``train_loop``'s checkpoints:
    {"params": {path: fp32}, "opt": {"step": int32, "m", "v": {path:
    the moment dtype}}}, every tensor on the meta device."""
    cfg, moments = model.cfg, model.parallel.adam_moment_dtype

    def like(dtype):
        return flatten(map_schema(lambda _, d: torch.empty(
            d.shape, dtype=d.dtype or dtype, device="meta"),
            Model.schema_of(cfg, model.parallel)))

    return {"params": like(cfg.param_dtype),
            "opt": {"step": torch.empty((), dtype=torch.int32,
                                        device="meta"),
                    "m": like(moments), "v": like(moments)}}


def state_shardings(model: Model, rules, mesh) -> Dict[str, Any]:
    """The train state's ``NamedSharding``s on ``mesh``, nested as
    ``state_template``: the parameters' under ``rules``, the AdamW
    moments' the same, the step replicated."""
    from repro_torch.distributed.sharding import NamedSharding, P
    psh = flatten(model.param_shardings(rules, mesh))
    return {"params": psh,
            "opt": {"step": NamedSharding(mesh, P()), "m": psh, "v": psh}}


def elastic_restore(manager: CheckpointManager, model: Model, rules=None,
                    mesh=None, *, step: Optional[int] = None, device=None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(state, meta) of the latest checkpoint (or ``step``), leaf for
    leaf against ``state_template`` (a changed layout fails loudly
    instead of misloading): on ``mesh`` every leaf a ``DTensor`` under
    ``state_shardings(model, rules, mesh)`` (``rules`` defaults to the
    model's), else on ``device`` (the model's by default)."""
    if mesh is None:
        return manager.restore(state_template(model), step=step,
                               device=device if device is not None
                               else model.device)
    rules = rules if rules is not None else model.rules
    if rules is None:
        raise ValueError("elastic_restore onto a mesh needs sharding rules "
                         "(the model has none)")
    return manager.restore(state_template(model), step=step,
                           shardings=state_shardings(model, rules, mesh))


def sweep_checkpoint_manager(directory: str, spec, *,
                             keep_best: int = 1) -> CheckpointManager:
    """A CheckpointManager sized for a per-column sweep checkpoint (step
    = column index): it keeps every column plus one save in flight, so
    no column is pruned before the sweep ends (``sweep`` raises
    ``keep_latest`` to the same floor)."""
    return CheckpointManager(directory, keep_latest=len(spec.columns) + 1,
                             keep_best=keep_best)


def elastic_sweep(spec, *, directory: str, data_mesh=None, **sweep_kwargs):
    """Run, or resume, ``sweep(spec, ...)`` with a checkpoint a column in
    ``directory``: a second call restores every completed column (tagged
    "restored") and recomputes only missing or failed ones.
    ``data_mesh`` and ``sweep_kwargs`` pass through to ``sweep``."""
    from repro_torch.sweep import sweep

    manager = sweep_checkpoint_manager(directory, spec)
    return sweep(spec, data_mesh=data_mesh, checkpoint=manager, resume=True,
                 **sweep_kwargs)
