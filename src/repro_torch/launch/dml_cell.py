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

The reference lowers these steps against a production mesh for its cost
and dry-run tooling (``row_sharding``, ``lower_dml_cell``,
``lower_iv_cell``); those come with the next launch slice (ROADMAP
A.14b).
"""
from __future__ import annotations

from typing import Dict, Tuple

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
