"""Elastic resume of a sweep: run it with per-column checkpoints, and on
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

The reference's ``state_template`` / ``state_shardings`` /
``elastic_restore`` re-place an LM train state onto a new mesh's
shardings; they come with the LM training side (ROADMAP A.13f) and the
launch tooling (A.14), with ``CheckpointManager.restore(shardings=)``.
"""
from __future__ import annotations

from repro_torch.checkpoint.manager import CheckpointManager


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
