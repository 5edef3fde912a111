"""The many-cohorts sweep as a single step: E per-segment DML fits at
the §5.3 scale, the paper's case-study workload (many effects a run,
not one).  Two executions of the same estimation:

  mode="segmented"  the one-pass segment × fold Gram kernels
                    (``sweep.segmented``), folds drawn from seed 0 —
                    the many-effects-cheaply execution;
  mode="cells"      E masked weighted single fits of the dml cell,
                    batched on a leading cell axis, each cell's folds
                    from the lineage of column 0 under seed 0 — bitwise
                    ``serial_loop("dml", cfg, seed=0, col_index=0)``.

    step = make_sweep_step(cfg, 64, "segmented")
    theta, se = step(X, y, t, sids)           # (E, p_phi) each

Inside ``use_data_mesh`` with ``cfg.row_block > 0`` the blocked moments
row-shard over the mesh's ranks (the segmented mode's MM loop stays
whole-array).  On a device mesh the inputs are ``DTensor``s placed by
``row_sharding`` (rows over every mesh axis, the segment ids as data),
and the segmented mode reads each rank's own rows
(``sweep/segmented.py``); ``lower_sweep_cell`` traces that step as rank
0 of the production mesh (``launch/dml_cell.lower_step``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.registry import get_spec
from repro_torch.device import DeviceLike, as_f32
from repro_torch.inference.executor import make_executor
from repro_torch.launch.dml_cell import (N_COVARIATES, N_ROWS, _fit_device,
                                         lower_step)
from repro_torch.sweep import engine
from repro_torch.sweep.segmented import segmented_dml_sweep

Tensor = torch.Tensor

N_SEGMENTS = 64


def make_sweep_step(cfg: CausalConfig, n_segments: int = N_SEGMENTS,
                    mode: str = "segmented", *, device: DeviceLike = None):
    """``sweep_fit(X, y, t, sids) -> (theta, se)``, each (E, p_phi): one
    full E-segment sweep column, segment ids passed in as data, inputs
    moved to ``device`` (None: the CUDA card)."""
    if mode not in ("segmented", "cells"):
        raise ValueError(f"unknown sweep cell mode {mode!r} "
                         "(segmented | cells)")
    dev = _fit_device(device)
    cell = get_spec("dml").weighted_fit(cfg) if mode == "cells" else None

    def sweep_fit(X, y, t, sids) -> Tuple[Tensor, Tensor]:
        X, y, t = (as_f32(a, dev) for a in (X, y, t))
        sids = torch.as_tensor(sids, device=dev).long()
        if mode == "segmented":
            out = segmented_dml_sweep(cfg, X, y, t, sids, n_segments,
                                      torch.Generator().manual_seed(0))
            return out["theta"], out["se"]
        data = engine._column_data({"X": X, "y": y, "t": t, "sids": sids},
                                   cfg)
        out = make_executor("vmap").map(
            engine._make_masked_cell(cell, cfg.n_folds),
            engine._cells(0, 0, n_segments), data)
        return out["theta"], out["se"]

    return sweep_fit


def input_specs(n: int = N_ROWS, p: int = N_COVARIATES
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of the step's inputs."""
    f32 = torch.float32
    return {"X": ((n, p), f32), "y": ((n,), f32), "t": ((n,), f32),
            "sids": ((n,), torch.int64)}


def row_sharding(mesh) -> Dict[str, Any]:
    """{name: NamedSharding}: rows over EVERY mesh axis jointly, the
    segment ids too; the segments batch inside the step."""
    from repro_torch.distributed.sharding import NamedSharding, P
    axes = tuple(mesh.mesh_dim_names)
    return {"X": NamedSharding(mesh, P(axes, None)),
            "y": NamedSharding(mesh, P(axes)),
            "t": NamedSharding(mesh, P(axes)),
            "sids": NamedSharding(mesh, P(axes))}


def lower_sweep_cell(mesh, cfg: CausalConfig = None, n: int = N_ROWS,
                     p: int = N_COVARIATES, n_segments: int = N_SEGMENTS,
                     mode: str = "segmented"):
    """One E-segment sweep step at n × p on ``mesh``
    (``dml_cell.lower_step``), its inputs placed by ``row_sharding``."""
    cfg = cfg or CausalConfig(n_folds=5, cate_features=1)
    return lower_step(mesh, make_sweep_step(cfg, n_segments, mode,
                                            device="cpu"),
                      ("X", "y", "t", "sids"), input_specs(n, p),
                      row_sharding(mesh))
