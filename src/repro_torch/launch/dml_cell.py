"""The paper's workloads as single steps: one fold-parallel DML fit (a
5-fold ridge + logistic cross-fit and the orthogonal final stage) and
its orthogonal-IV sibling (three cross-fit nuisances and the
instrumented final stage), at the §5.3 scale — n = 2^20 rows × p = 500
covariates.

Each step is one full fit with the folds passed in as data, built from
the port's own engines: ``crossfit_one`` for each nuisance,
``fit_final_stage`` / ``fit_iv_final_stage`` for the last stage.  Given
the folds ``DML`` / ``OrthoIV`` draw, a step is bitwise their fit on the
same config.  Inside ``use_data_mesh`` with ``cfg.row_block > 0`` every
moments pass of the step row-shards over the mesh's ranks — under
"pallas" one seg_gram launch a block on the rank that owns it.

    step = make_dml_step(cfg)                 # engine "parallel"
    theta, cov = step(X, y, t, folds)

On a device mesh the inputs are ``DTensor``s placed by ``row_sharding``:
rows over every mesh axis jointly, the fold ids as data beside them.
Each rank then reads only its own rows: every moments pass is its rows'
share (one kernel launch on its shard under "pallas") summed across the
mesh (``distributed/sharding.row_sum``), and the row-wise work
(predictions, residuals) stays on its shard.  Outside a mesh every path
is the plain one.

    with mesh_context(mesh), dtensor_ops():
        theta, cov = step(*placed_inputs)

``lower_dml_cell`` / ``lower_iv_cell`` are the reference's lowerings
against the production mesh, in torch: one step traced as rank 0 of the
mesh under ``FakeTensorMode`` (shapes, no memory, the CPU's plain
routes) with ``launch/op_cost.count`` — per-rank flops, bytes, the
collectives and the peak — as ``launch/dryrun.trace_cell`` traces the
LM cells; ``dryrun --paper-cell`` reports them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.crossfit import crossfit_one
from repro_torch.core.final_stage import cate_basis, fit_final_stage
from repro_torch.core.iv import fit_iv_final_stage
from repro_torch.core.nuisance import make_nuisance
from repro_torch.device import DeviceLike, as_f32, resolve_device

Tensor = torch.Tensor

N_ROWS = 1_048_576  # the paper's "1 Million", padded to 2^20
N_COVARIATES = 500


def _fit_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_dml_step(cfg: CausalConfig, engine: str = "parallel", *,
                  device: DeviceLike = None):
    """``dml_fit(X, y, t, folds) -> (theta, cov)``: one DML fit on the
    given folds through ``crossfit_one``'s ``engine`` ("parallel": the
    fold-batched fits; "parallel_loo": the leave-one-out Gram), inputs
    moved to ``device`` (None: the CUDA card)."""
    dev = _fit_device(device)
    ridge = make_nuisance(cfg.nuisance_y, "reg", cfg)
    logit = make_nuisance(cfg.nuisance_t,
                          "clf" if cfg.discrete_treatment else "reg", cfg)

    def dml_fit(X, y, t, folds) -> Tuple[Tensor, Tensor]:
        X, y, t = (as_f32(a, dev) for a in (X, y, t))
        folds = torch.as_tensor(folds, device=dev).long()
        gen = torch.Generator().manual_seed(0)
        k = cfg.n_folds
        my, _ = crossfit_one(ridge, gen, X, y, folds, k, engine)
        mt, _ = crossfit_one(logit, gen, X, t, folds, k, engine)
        phi = cate_basis(X, cfg.cate_features)
        fs = fit_final_stage(y, t, my, mt, phi, row_block=cfg.row_block,
                             strategy=cfg.row_block_strategy)
        return fs.theta, fs.cov

    return dml_fit


def make_iv_step(cfg: CausalConfig, engine: str = "parallel", *,
                 device: DeviceLike = None):
    """``iv_fit(X, y, t, z, folds) -> (theta, cov)``: one OrthoIV fit on
    the given folds — the same engine run for E[Y|X], E[T|X] and E[Z|X],
    then the instrumented final stage (``iv_gram`` / ``iv_meat``)."""
    dev = _fit_device(device)
    ridge = make_nuisance(cfg.nuisance_y, "reg", cfg)
    logit_t = make_nuisance(cfg.nuisance_t,
                            "clf" if cfg.discrete_treatment else "reg", cfg)
    logit_z = make_nuisance(cfg.nuisance_z,
                            "clf" if cfg.discrete_instrument else "reg", cfg)

    def iv_fit(X, y, t, z, folds) -> Tuple[Tensor, Tensor]:
        X, y, t, z = (as_f32(a, dev) for a in (X, y, t, z))
        folds = torch.as_tensor(folds, device=dev).long()
        gen = torch.Generator().manual_seed(0)
        k = cfg.n_folds
        my, _ = crossfit_one(ridge, gen, X, y, folds, k, engine)
        mt, _ = crossfit_one(logit_t, gen, X, t, folds, k, engine)
        mz, _ = crossfit_one(logit_z, gen, X, z, folds, k, engine)
        phi = cate_basis(X, cfg.cate_features)
        fs = fit_iv_final_stage(y - my, t - mt, z - mz, phi,
                                row_block=cfg.row_block,
                                strategy=cfg.row_block_strategy)
        return fs.theta, fs.cov

    return iv_fit


def input_specs(n: int = N_ROWS, p: int = N_COVARIATES,
                with_instrument: bool = False
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of a step's inputs."""
    f32 = torch.float32
    specs = {"X": ((n, p), f32), "y": ((n,), f32), "t": ((n,), f32),
             "folds": ((n,), torch.int64)}
    if with_instrument:
        specs["z"] = ((n,), f32)
    return specs


def row_sharding(mesh, with_instrument: bool = False) -> Dict[str, Any]:
    """{name: NamedSharding} of a step's inputs: rows over EVERY mesh
    axis jointly (the paper's one giant data axis), the fold ids too;
    the folds batch inside the step."""
    from repro_torch.distributed.sharding import NamedSharding, P
    axes = tuple(mesh.mesh_dim_names)
    sh = {"X": NamedSharding(mesh, P(axes, None)),
          "y": NamedSharding(mesh, P(axes)),
          "t": NamedSharding(mesh, P(axes)),
          "folds": NamedSharding(mesh, P(axes))}
    if with_instrument:
        sh["z"] = NamedSharding(mesh, P(axes))
    return sh


def lower_step(mesh, step: Callable[..., Any], names: Sequence[str],
               specs: Dict[str, Any], shardings: Dict[str, Any]):
    """(CostTotals, argument bytes of this rank) of one ``step(*inputs)``
    traced as this rank of ``mesh``: under ``FakeTensorMode`` each input
    is zeros of its spec placed under its sharding, and
    ``launch/op_cost.count`` counts the step's local ops and
    collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (distribute, dtensor_ops,
                                                  mesh_context)
    from repro_torch.launch import op_cost
    with FakeTensorMode(), dtensor_ops(), mesh_context(mesh):
        inputs = [distribute(torch.zeros(specs[k][0], dtype=specs[k][1]),
                             shardings[k])
                  for k in names]
        args = sum(x.to_local().numel() * x.element_size() for x in inputs)
        with op_cost.count() as totals:
            step(*inputs)
    return totals, args


def lower_dml_cell(mesh, cfg: CausalConfig = None, n: int = N_ROWS,
                   p: int = N_COVARIATES, engine: str = "parallel"):
    """One DML step at n × p on ``mesh`` (``lower_step``), its inputs
    placed by ``row_sharding``."""
    cfg = cfg or CausalConfig(n_folds=5, cate_features=1)
    return lower_step(mesh, make_dml_step(cfg, engine, device="cpu"),
                      ("X", "y", "t", "folds"), input_specs(n, p),
                      row_sharding(mesh))


def lower_iv_cell(mesh, cfg: CausalConfig = None, n: int = N_ROWS,
                  p: int = N_COVARIATES, engine: str = "parallel"):
    """The OrthoIV step at n × p on ``mesh``: the same row sharding plus
    the instrument column."""
    cfg = cfg or CausalConfig(n_folds=5, cate_features=1)
    return lower_step(mesh, make_iv_step(cfg, engine, device="cpu"),
                      ("X", "y", "t", "z", "folds"),
                      input_specs(n, p, with_instrument=True),
                      row_sharding(mesh, with_instrument=True))
