"""Double/Debiased ML (Chernozhukov et al. 2018) — the algorithm the
paper scales, on the card.

    est = DML(CausalConfig(n_folds=5, nuisance_y="ridge",
                           nuisance_t="logistic", cate_features=2))
    res = est.fit(y, t, X, gen=torch.Generator().manual_seed(0))
    res.theta, res.stderr
    res.ate_interval()         # B = cfg.n_bootstrap pairs-bootstrap refits
    res.cate_interval(X)       # (cfg.inference: bootstrap | multiplier |
                               #  jackknife | none)

``DML(cfg, device="cpu")`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.crossfit import CrossfitResult, crossfit
from repro_torch.core.estimands import Diagnostics, compute_diagnostics
from repro_torch.core.estimator import (SandwichEffectResult, inf_cache_field,
                                        resolve_scheme)
from repro_torch.core.final_stage import (FinalStageResult, cate_basis,
                                          fit_final_stage)
from repro_torch.core.nuisance import Nuisance, make_nuisance
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.draws import derive_seed

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FitContext:
    """What replicate inference needs to re-run the fit; bootstrap
    replicates derive their draws from ``seed`` (the initial seed of the
    fit's generator)."""

    y: Tensor
    t: Tensor
    XW: Tensor        # nuisance covariates (X ++ W)
    phi: Tensor       # (n, p_phi) CATE basis
    seed: int
    nuis_y: Nuisance
    nuis_t: Nuisance


@dataclasses.dataclass(frozen=True)
class DMLResult(SandwichEffectResult):
    """A fitted DML: final-stage theta, HC0 cov, cross-fit state and
    diagnostics."""

    theta: Tensor             # (p_phi,) final-stage coefficients
    cov: Tensor               # (p_phi, p_phi)
    cfg: CausalConfig
    crossfit: CrossfitResult
    final: FinalStageResult
    diagnostics: Diagnostics
    fit_ctx: Optional[FitContext] = None
    _inf_cache: Dict[Any, Any] = inf_cache_field()

    estimator_name = "DML"

    def _replicate_inference(self, method, n_boot, exe, alpha):
        """The delete-fold jackknife off the existing fold states, or B
        weighted refits (pairs / multiplier bootstrap) through an
        executor."""
        from repro_torch.inference.bootstrap import dml_bootstrap
        from repro_torch.inference.jackknife import delete_fold_jackknife
        ctx, cfg = self.fit_ctx, self.cfg
        if method == "jackknife":
            cf = self.crossfit
            return delete_fold_jackknife(
                ctx.y, ctx.t, cf.oof_y, cf.oof_t, cf.folds, ctx.phi,
                cfg.n_folds, alpha=alpha, executor=exe, point=self.theta,
                point_se=self.stderr, row_block=cfg.row_block,
                **self._runtime_kwargs())
        return dml_bootstrap(
            ctx.nuis_y, ctx.nuis_t, n_folds=cfg.n_folds, XW=ctx.XW, y=ctx.y,
            t=ctx.t, phi=ctx.phi, seed=derive_seed(ctx.seed, 0x0b00),
            n_replicates=n_boot, scheme=resolve_scheme(method), executor=exe,
            alpha=alpha, point=self.theta, point_se=self.stderr,
            row_block=cfg.row_block, strategy=cfg.row_block_strategy,
            **self._runtime_kwargs())

    def _summary_extra(self):
        d = self.diagnostics
        return (f"ortho-moment |E[e·rt]| = {d.ortho_moment:.2e}",
                f"overlap: propensity in [{d.min_propensity:.3f}, "
                f"{d.max_propensity:.3f}]",
                f"nuisance R²(y) = {d.nuisance_r2_y:.3f}")


class DML:
    """The estimator facade.  Nuisances default from the CausalConfig;
    ``device=None`` runs on the CUDA card (and raises without one)."""

    def __init__(self, cfg: CausalConfig,
                 nuisance_y: Optional[Nuisance] = None,
                 nuisance_t: Optional[Nuisance] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        t_task = "clf" if cfg.discrete_treatment else "reg"
        self.nuis_y = nuisance_y or make_nuisance(cfg.nuisance_y, "reg", cfg)
        self.nuis_t = nuisance_t or make_nuisance(cfg.nuisance_t, t_task, cfg)

    def fit(self, y, t, X, W=None,
            gen: Optional[torch.Generator] = None) -> DMLResult:
        """y, t: (n,); X: (n, p) effect-relevant covariates; W: optional
        extra controls (nuisance fitting only).  Inputs are moved to the
        estimator's device as fp32; ``gen`` draws the folds (default:
        a CPU generator seeded 0), and its initial seed is the one the
        bootstrap replicates derive from."""
        dev = self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        y, t, X = as_f32(y, dev), as_f32(t, dev), as_f32(X, dev)
        XW = X if W is None else torch.cat([X, as_f32(W, dev)], dim=1)
        cf = crossfit(self.nuis_y, self.nuis_t, gen, XW, y, t,
                      self.cfg.n_folds, self.cfg.engine)
        phi = cate_basis(X, self.cfg.cate_features)
        fs = fit_final_stage(y, t, cf.oof_y, cf.oof_t, phi,
                             row_block=self.cfg.row_block,
                             strategy=self.cfg.row_block_strategy)
        diag = compute_diagnostics(y, t, cf.oof_y, cf.oof_t, phi @ fs.theta)
        ctx = FitContext(y=y, t=t, XW=XW, phi=phi, seed=gen.initial_seed(),
                         nuis_y=self.nuis_y, nuis_t=self.nuis_t)
        return DMLResult(theta=fs.theta, cov=fs.cov, cfg=self.cfg,
                         crossfit=cf, final=fs, diagnostics=diag,
                         fit_ctx=ctx)
