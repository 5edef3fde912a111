"""Doubly-robust (AIPW) learner — the DR baseline the paper cites (§2.2,
Foster & Syrgkanis 2019) — on the card, over the same fold-batched fits
as DML.

Pseudo-outcome (binary treatment):

    ψ_i = m1(x_i) - m0(x_i)
        + t_i (y_i - m1(x_i)) / e(x_i)
        - (1 - t_i)(y_i - m0(x_i)) / (1 - e(x_i))

with cross-fit outcome models m_t(x) = E[Y|X,T=t] and propensity
e(x) = P(T=1|X), clipped to [clip, 1 - clip].  ATE = mean(ψ); CATE =
ψ regressed on phi(x), one augmented Gram ``[phi | ψ]`` and a solve.
Consistent if EITHER the outcome models or the propensity is.

    res = DRLearner(cfg).fit(y, t, X, gen=torch.Generator().manual_seed(0))
    res.ate, res.stderr, res.ate_interval(), res.cate_interval(X)

The three nuisances (ridge and logistic, as the bootstrap refits them)
fit all k folds at once under the weights ``fold_weights(folds) * arm``
(arm = 1 - t, t or 1): the fold-batched weighted fit of the bootstrap,
whose every Gram is one launch of the segment-Gram kernel's
fold_weighted form on the card under ``row_block_strategy="pallas"``.
Inference: the pairs / multiplier bootstrap of the whole pipeline
(``dr_bootstrap``); DR has no fold-state jackknife, so "jackknife" runs
the bootstrap.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core import moments
from repro_torch.core.crossfit import _oof_select, fold_ids, fold_weights
from repro_torch.core.estimator import (PseudoOutcomeEffectResult,
                                        inf_cache_field, resolve_scheme)
from repro_torch.core.final_stage import cate_basis
from repro_torch.core.nuisance import Nuisance, make_logistic, make_ridge
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.draws import derive_seed

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DRFitContext:
    """What the bootstrap needs to re-run the fit; its replicates derive
    their draws from ``seed``."""

    X: Tensor
    y: Tensor
    t: Tensor
    phi: Tensor
    seed: int
    outcome: Nuisance
    propensity: Nuisance
    clip: float


@dataclasses.dataclass(frozen=True)
class DRResult(PseudoOutcomeEffectResult):
    """A fitted DRLearner: the ATE (mean ψ) with its stderr, the CATE
    coefficients on phi(x) and the pseudo-outcomes."""

    ate: float
    stderr: float
    theta: Tensor             # (p_phi,) CATE coefficients on phi(x)
    pseudo: Tensor            # (n,) AIPW pseudo-outcomes
    cfg: Optional[CausalConfig] = None
    fit_ctx: Optional[DRFitContext] = None
    _inf_cache: Dict[Any, Any] = inf_cache_field()

    estimator_name = "DRLearner"

    def _resolve_method(self, method):
        # DR has no fold-state shortcut; a delete-fold jackknife would be
        # another estimator, so the bootstrap stands in for it
        return "bootstrap" if method == "jackknife" else method

    def _replicate_inference(self, method, n_boot, exe, alpha):
        """B weighted refits of the whole AIPW pipeline through an
        executor; the ATE functional's own draws ride along."""
        from repro_torch.inference.bootstrap import dr_bootstrap
        cfg, ctx = self._config(), self.fit_ctx
        return dr_bootstrap(
            ctx.outcome, ctx.propensity, n_folds=cfg.n_folds, X=ctx.X,
            y=ctx.y, t=ctx.t, phi=ctx.phi, seed=derive_seed(ctx.seed, 0x0b00),
            n_replicates=n_boot, scheme=resolve_scheme(method), executor=exe,
            alpha=alpha, clip=ctx.clip, point=self.theta, ate_point=self.ate,
            row_block=cfg.row_block, strategy=cfg.row_block_strategy,
            **self._runtime_kwargs())


class DRLearner:
    """fit(y, t, X) with three cross-fit nuisances (m0, m1, e) and the
    pseudo-outcome regression; ``device=None`` runs on the CUDA card."""

    def __init__(self, cfg: CausalConfig,
                 outcome: Optional[Nuisance] = None,
                 propensity: Optional[Nuisance] = None,
                 clip: float = 0.01, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.outcome = outcome or make_ridge(
            cfg.ridge_lambda, row_block=cfg.row_block,
            strategy=cfg.row_block_strategy)
        self.propensity = propensity or make_logistic(
            cfg.ridge_lambda, cfg.newton_iters, row_block=cfg.row_block,
            strategy=cfg.row_block_strategy)
        self.clip = clip

    def _crossfit_outcome_arm(self, X: Tensor, y: Tensor, t: Tensor,
                              folds: Tensor, arm: int,
                              gen: Optional[torch.Generator] = None
                              ) -> Tensor:
        """Cross-fit E[Y|X, T=arm]: the training weights select the
        fold's complement AND the arm; an mlp draws its fold inits on
        ``gen`` (``fit_predict_folds``)."""
        from repro_torch.inference.bootstrap import fit_predict_folds
        arm_mask = (t == arm).to(_F32)[None, :]
        W = fold_weights(folds, self.cfg.n_folds)
        return _oof_select(fit_predict_folds(self.outcome, X, y,
                                             W * arm_mask,
                                             None if gen is None else [gen]),
                           folds)

    def fit(self, y, t, X, gen: Optional[torch.Generator] = None
            ) -> DRResult:
        """y, t: (n,), t binary; X: (n, p).  ``gen`` draws the folds,
        then an mlp nuisance's fold inits (default: a CPU generator
        seeded 0); its initial seed is the one the bootstrap replicates
        derive from."""
        from repro_torch.inference.bootstrap import fit_predict_folds
        from repro_torch.inference.numerics import det_solve
        dev, cfg = self.device, self.cfg
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        y, t, X = as_f32(y, dev), as_f32(t, dev), as_f32(X, dev)
        n, k = X.shape[0], cfg.n_folds
        folds = fold_ids(gen, n, k, device=dev)

        m0 = self._crossfit_outcome_arm(X, y, t, folds, 0, gen)
        m1 = self._crossfit_outcome_arm(X, y, t, folds, 1, gen)
        e = _oof_select(fit_predict_folds(self.propensity, X, t,
                                          fold_weights(folds, k), [gen]),
                        folds)
        e = torch.clamp(e, self.clip, 1.0 - self.clip)

        psi = (m1 - m0 + t * (y - m1) / e
               - (1.0 - t) * (y - m0) / (1.0 - e))
        ate = float(psi.mean())
        se = float(psi.std(correction=1) / n ** 0.5)

        # the pseudo-outcome regression: one augmented-moments pass with
        # psi as the appended column
        phi = cate_basis(X, cfg.cate_features)
        q = phi.shape[1]
        Gaug, _ = moments.weighted_gram(
            phi, torch.ones((n,), dtype=_F32, device=dev), append=psi,
            row_block=cfg.row_block, strategy=cfg.row_block_strategy)
        G = Gaug[:q, :q] + 1e-8 * n * torch.eye(q, dtype=_F32, device=dev)
        theta = det_solve(G, Gaug[:q, q])
        ctx = DRFitContext(X=X, y=y, t=t, phi=phi, seed=gen.initial_seed(),
                           outcome=self.outcome, propensity=self.propensity,
                           clip=self.clip)
        return DRResult(ate=ate, stderr=se, theta=theta, pseudo=psi,
                        cfg=cfg, fit_ctx=ctx)
