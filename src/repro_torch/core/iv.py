"""Orthogonal instrumental-variable estimation (OrthoIV) on the card.

Partially-linear IV: cross-fit m_y = E[Y|X], m_t = E[T|X] and
m_z = E[Z|X] over one fold assignment, then solve the residual-on-
residual 2SLS moment

    E[ rz · φ(x) · (ry - <θ, φ(x)>·rt) ] = 0
    ⇒  (Σ rz·rt·φφᵀ) θ = Σ rz·ry·φ

off one instrumented augmented Gram (``moments.iv_gram``, the
M = [rz·φ | rt·φ | ry] form: the segment-Gram kernel's iv builder on
the card under ``row_block_strategy="pallas"``).  With the constant
basis θ is the Wald ratio of residual covariances; under binary-Z
compliance designs it targets the LATE.

    res = OrthoIV(cfg).fit(y, t, z, X, gen=torch.Generator().manual_seed(0))
    res.late, res.stderr, res.late_interval(), res.cate_interval(X)

Inference: the HC0 sandwich, the delete-fold jackknife (one
fold-segmented instrumented Gram) and the pairs / multiplier bootstrap
(``iv_bootstrap``).

DRIV — the doubly-robust IV CATE (Syrgkanis et al. 2019; EconML's
DRIV): one more cross-fit nuisance β(x) = E[rt·rz|X] on the same folds
(the conditional compliance covariance, clipped away from zero), a
preliminary constant OrthoIV estimate θ_pre, and the pseudo-outcome

    ψ = θ_pre + (ry - θ_pre·rt) · rz / clip(β(x))

regressed on φ(x); mean ψ is the LATE functional.  Its inference is the
pairs / multiplier bootstrap of the whole pipeline (``driv_bootstrap``);
it has no delete-fold jackknife.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core import moments
from repro_torch.core.crossfit import crossfit_one, fold_ids
from repro_torch.core.estimands import IVDiagnostics, compute_iv_diagnostics
from repro_torch.core.estimator import (PseudoOutcomeEffectResult,
                                        SandwichEffectResult, inf_cache_field,
                                        resolve_scheme)
from repro_torch.core.final_stage import cate_basis
from repro_torch.core.nuisance import Nuisance, make_nuisance, make_ridge
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.draws import derive_seed

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class IVCrossfitResult:
    """Out-of-fold nuisance predictions of the three IV targets."""

    oof_y: Tensor      # (n,) out-of-fold E[Y|X]
    oof_t: Tensor      # (n,) out-of-fold E[T|X]
    oof_z: Tensor      # (n,) out-of-fold E[Z|X]
    folds: Tensor      # (n,) fold assignment
    states_y: Any
    states_t: Any
    states_z: Any


def iv_crossfit(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance,
                gen: torch.Generator, X: Tensor, y: Tensor, t: Tensor,
                z: Tensor, k: int, engine: str = "parallel"
                ) -> IVCrossfitResult:
    """Cross-fit the three IV nuisances over one fold assignment drawn
    on ``gen``, each through ``crossfit_one``'s engine."""
    folds = fold_ids(gen, X.shape[0], k, device=X.device)
    oof_y, st_y = crossfit_one(nuis_y, gen, X, y, folds, k, engine)
    oof_t, st_t = crossfit_one(nuis_t, gen, X, t, folds, k, engine)
    oof_z, st_z = crossfit_one(nuis_z, gen, X, z, folds, k, engine)
    return IVCrossfitResult(oof_y=oof_y, oof_t=oof_t, oof_z=oof_z,
                            folds=folds, states_y=st_y, states_t=st_t,
                            states_z=st_z)


@dataclasses.dataclass(frozen=True)
class IVFinalStageResult:
    """Instrumented final-stage coefficients and HC0 covariance."""

    theta: Tensor       # (p_phi,)
    cov: Tensor         # (p_phi, p_phi) HC0 sandwich
    j_gram: Tensor      # (p_phi, p_phi) Σ rz·rt·φφᵀ / n
    n: int

    @property
    def stderr(self) -> Tensor:
        """Sandwich standard errors."""
        return torch.sqrt(torch.diagonal(self.cov))


def fit_iv_final_stage(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor, *,
                       w: Optional[Tensor] = None, ridge: float = 1e-8,
                       row_block: int = 0, strategy: Optional[str] = None
                       ) -> IVFinalStageResult:
    """Solve the instrumented orthogonal moment Jθ = b with its HC0
    sandwich: one ``iv_gram`` pass and one ``iv_meat`` pass, streamed
    in row blocks when ``row_block > 0`` (through the kernel under
    ``strategy="pallas"``), and Gauss-Jordan solves: the point fit is
    the w = 1 weighted replicate (``weighted_iv_theta``), bitwise."""
    from repro_torch.inference.numerics import det_solve, sandwich
    n, p = phi.shape
    ws = torch.ones_like(phi[:, 0], dtype=_F32) if w is None \
        else w.to(_F32)
    Gaug, n_eff = moments.iv_gram(ry, rt, rz, phi, ws, row_block=row_block,
                                  strategy=strategy)
    J, b, _, _ = moments.iv_slices(Gaug, p)
    n_eff = torch.clamp(n_eff, min=1.0)
    A = J + ridge * n_eff * torch.eye(p, dtype=_F32, device=phi.device)
    theta = det_solve(A, b)
    meat = moments.iv_meat(ry, rt, rz, phi, theta, w=w, row_block=row_block,
                           strategy=strategy)
    return IVFinalStageResult(theta=theta, cov=sandwich(A, meat),
                              j_gram=J / n, n=n)


@dataclasses.dataclass(frozen=True)
class IVFitContext:
    """What replicate inference needs to re-run the fit; bootstrap
    replicates derive their draws from ``seed``."""

    y: Tensor
    t: Tensor
    z: Tensor
    XW: Tensor        # nuisance covariates (X ++ W)
    phi: Tensor       # (n, p_phi) CATE basis
    seed: int
    nuis_y: Nuisance
    nuis_t: Nuisance
    nuis_z: Nuisance
    compliance: Optional[Nuisance] = None   # DRIV's β(x) nuisance


@dataclasses.dataclass(frozen=True)
class OrthoIVResult(SandwichEffectResult):
    """A fitted OrthoIV: theta (``late`` = theta[0]), HC0 cov, the three
    cross-fits and instrument diagnostics."""

    theta: Tensor
    cov: Tensor
    cfg: CausalConfig
    crossfit: IVCrossfitResult
    final: IVFinalStageResult
    diagnostics: IVDiagnostics
    fit_ctx: Optional[IVFitContext] = None
    _inf_cache: Dict[Any, Any] = inf_cache_field()

    estimator_name = "OrthoIV"

    def _replicate_inference(self, method, n_boot, exe, alpha):
        """The delete-fold jackknife off one fold-segmented instrumented
        Gram, or B weighted 2SLS refits through an executor."""
        from repro_torch.inference.bootstrap import iv_bootstrap
        from repro_torch.inference.jackknife import delete_fold_jackknife_iv
        ctx, cfg = self.fit_ctx, self.cfg
        if method == "jackknife":
            cf = self.crossfit
            return delete_fold_jackknife_iv(
                ctx.y, ctx.t, ctx.z, cf.oof_y, cf.oof_t, cf.oof_z, cf.folds,
                ctx.phi, cfg.n_folds, alpha=alpha, executor=exe,
                point=self.theta, point_se=self.stderr,
                row_block=cfg.row_block, strategy=cfg.row_block_strategy,
                **self._runtime_kwargs())
        return iv_bootstrap(
            ctx.nuis_y, ctx.nuis_t, ctx.nuis_z, n_folds=cfg.n_folds,
            XW=ctx.XW, y=ctx.y, t=ctx.t, z=ctx.z, phi=ctx.phi,
            seed=derive_seed(ctx.seed, 0x1b00), n_replicates=n_boot,
            scheme=resolve_scheme(method), executor=exe, alpha=alpha,
            point=self.theta, point_se=self.stderr, row_block=cfg.row_block,
            strategy=cfg.row_block_strategy, **self._runtime_kwargs())

    def _summary_extra(self):
        d = self.diagnostics
        flag = "WEAK" if d.weak_instrument else "ok"
        return (f"IV-moment |E[e·rz]| = {d.ortho_moment:.2e}",
                f"first-stage F = {d.first_stage_f:.1f} [{flag}]",
                f"corr(rz, rt) = {d.instrument_corr:+.3f}",
                f"instrument overlap: E[Z|X] in "
                f"[{d.min_instrument_propensity:.3f}, "
                f"{d.max_instrument_propensity:.3f}]")


class OrthoIV:
    """Partially-linear IV via the residual-on-residual 2SLS moment.
    The instrument nuisance follows ``cfg.nuisance_z`` for a discrete
    instrument and ridge for a continuous one whose configured kind is
    logistic; ``device=None`` runs on the CUDA card."""

    def __init__(self, cfg: CausalConfig,
                 nuisance_y: Optional[Nuisance] = None,
                 nuisance_t: Optional[Nuisance] = None,
                 nuisance_z: Optional[Nuisance] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        t_task = "clf" if cfg.discrete_treatment else "reg"
        z_task = "clf" if cfg.discrete_instrument else "reg"
        z_kind = cfg.nuisance_z if cfg.discrete_instrument else (
            "ridge" if cfg.nuisance_z == "logistic" else cfg.nuisance_z)
        self.nuis_y = nuisance_y or make_nuisance(cfg.nuisance_y, "reg", cfg)
        self.nuis_t = nuisance_t or make_nuisance(cfg.nuisance_t, t_task, cfg)
        self.nuis_z = nuisance_z or make_nuisance(z_kind, z_task, cfg)

    def fit(self, y, t, z, X, W=None,
            gen: Optional[torch.Generator] = None) -> OrthoIVResult:
        """y, t, z: (n,); X: (n, p) effect covariates; W: optional extra
        controls (nuisance fitting only).  ``gen`` draws the folds
        (default: a CPU generator seeded 0); its initial seed is the one
        the bootstrap replicates derive from."""
        dev = self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        y, t, z, X = (as_f32(a, dev) for a in (y, t, z, X))
        XW = X if W is None else torch.cat([X, as_f32(W, dev)], dim=1)
        cf = iv_crossfit(self.nuis_y, self.nuis_t, self.nuis_z, gen, XW, y,
                         t, z, self.cfg.n_folds, self.cfg.engine)
        ry, rt, rz = y - cf.oof_y, t - cf.oof_t, z - cf.oof_z
        phi = cate_basis(X, self.cfg.cate_features)
        fs = fit_iv_final_stage(ry, rt, rz, phi, row_block=self.cfg.row_block,
                                strategy=self.cfg.row_block_strategy)
        e = ry - (rt[:, None] * phi * fs.theta[None, :]).sum(dim=1)
        diag = compute_iv_diagnostics(t, z, cf.oof_t, cf.oof_z, e)
        ctx = IVFitContext(y=y, t=t, z=z, XW=XW, phi=phi,
                           seed=gen.initial_seed(), nuis_y=self.nuis_y,
                           nuis_t=self.nuis_t, nuis_z=self.nuis_z)
        return OrthoIVResult(theta=fs.theta, cov=fs.cov, cfg=self.cfg,
                             crossfit=cf, final=fs, diagnostics=diag,
                             fit_ctx=ctx)


def clip_compliance(beta: Tensor, clip: float) -> Tensor:
    """Sign-preserving magnitude floor on the compliance denominator
    β(x) = E[rt·rz|X] (EconML's cov_clip); zero clamps to +clip."""
    return torch.where(beta >= 0, torch.clamp(beta, min=clip),
                       torch.clamp(beta, max=-clip))


@dataclasses.dataclass(frozen=True)
class DRIVResult(PseudoOutcomeEffectResult):
    """A fitted DRIV: the LATE (mean ψ) with its stderr, the CATE
    coefficients on phi(x), the pseudo-outcomes, the preliminary
    constant OrthoIV estimate and the instrument diagnostics."""

    ate: float                # mean pseudo-outcome: the LATE functional
    stderr: float
    theta: Tensor             # (p_phi,) CATE coefficients on phi(x)
    pseudo: Tensor            # (n,) DRIV pseudo-outcomes
    theta_pre: float          # the preliminary constant OrthoIV estimate
    diagnostics: IVDiagnostics
    cfg: Optional[CausalConfig] = None
    fit_ctx: Optional[IVFitContext] = None
    _inf_cache: Dict[Any, Any] = inf_cache_field()

    estimator_name = "DRIV"

    @property
    def late(self) -> float:
        """The LATE functional (= ``ate``, the mean pseudo-outcome)."""
        return self.ate

    def _resolve_method(self, method):
        if method == "jackknife":
            # the pseudo-outcome depends on every fold's nuisances, so
            # there is no delete-fold shortcut; a bootstrap standing in
            # would make jackknife-vs-jackknife comparisons lie
            raise ValueError(
                "DRIV has no delete-fold jackknife; use "
                "method='bootstrap'|'multiplier', or OrthoIV for a "
                "jackknife over the instrumented moment")
        return method

    def _replicate_inference(self, method, n_boot, exe, alpha):
        """B weighted refits of the whole DRIV pipeline (nuisances,
        compliance, preliminary estimate, pseudo-outcome regression)
        through an executor; the LATE functional's draws ride along."""
        from repro_torch.inference.bootstrap import driv_bootstrap
        cfg, ctx = self._config(), self.fit_ctx
        return driv_bootstrap(
            ctx.nuis_y, ctx.nuis_t, ctx.nuis_z, ctx.compliance,
            n_folds=cfg.n_folds, XW=ctx.XW, y=ctx.y, t=ctx.t, z=ctx.z,
            phi=ctx.phi, seed=derive_seed(ctx.seed, 0x1b00),
            n_replicates=n_boot, scheme=resolve_scheme(method), executor=exe,
            alpha=alpha, cov_clip=cfg.iv_cov_clip, point=self.theta,
            ate_point=self.ate, row_block=cfg.row_block,
            strategy=cfg.row_block_strategy, **self._runtime_kwargs())

    def _summary_extra(self):
        d = self.diagnostics
        flag = "WEAK" if d.weak_instrument else "ok"
        return (f"preliminary OrthoIV θ_pre = {self.theta_pre:+.4f}",
                f"IV-moment |E[e·rz]| = {d.ortho_moment:.2e}",
                f"first-stage F = {d.first_stage_f:.1f} [{flag}]")


class DRIV:
    """fit(y, t, z, X): four cross-fit nuisances (m_y, m_t, m_z, β) and
    the doubly-robust pseudo-outcome regression; ``device=None`` runs on
    the CUDA card."""

    def __init__(self, cfg: CausalConfig,
                 nuisance_y: Optional[Nuisance] = None,
                 nuisance_t: Optional[Nuisance] = None,
                 nuisance_z: Optional[Nuisance] = None,
                 compliance: Optional[Nuisance] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        base = OrthoIV(cfg, nuisance_y, nuisance_t, nuisance_z, device)
        self.device = base.device
        self.nuis_y, self.nuis_t, self.nuis_z = (base.nuis_y, base.nuis_t,
                                                 base.nuis_z)
        # β(x) = E[rt·rz|X] is a regression whatever Z and T are
        self.compliance = compliance or make_ridge(
            cfg.ridge_lambda, row_block=cfg.row_block,
            strategy=cfg.row_block_strategy)

    def fit(self, y, t, z, X, W=None,
            gen: Optional[torch.Generator] = None) -> DRIVResult:
        """y, t, z: (n,); X: (n, p) effect covariates; W: optional extra
        controls.  ``gen`` draws the folds (default: a CPU generator
        seeded 0); the compliance fit's generator and the bootstrap's
        replicates derive from its initial seed."""
        from repro_torch.inference.numerics import det_solve
        cfg, dev = self.cfg, self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        seed = gen.initial_seed()
        y, t, z, X = (as_f32(a, dev) for a in (y, t, z, X))
        XW = X if W is None else torch.cat([X, as_f32(W, dev)], dim=1)
        n = X.shape[0]
        cf = iv_crossfit(self.nuis_y, self.nuis_t, self.nuis_z, gen, XW, y,
                         t, z, cfg.n_folds, cfg.engine)
        ry, rt, rz = y - cf.oof_y, t - cf.oof_t, z - cf.oof_z

        # the compliance nuisance on the SAME folds: β(x) = E[rt·rz | X]
        gb = torch.Generator().manual_seed(derive_seed(seed, 0xbe7a))
        oof_b, _ = crossfit_one(self.compliance, gb, XW, rt * rz, cf.folds,
                                cfg.n_folds, cfg.engine)
        beta = clip_compliance(oof_b, cfg.iv_cov_clip)

        # preliminary constant OrthoIV estimate (the same moment, phi = 1)
        ones = torch.ones((n, 1), dtype=_F32, device=dev)
        pre = fit_iv_final_stage(ry, rt, rz, ones, row_block=cfg.row_block,
                                 strategy=cfg.row_block_strategy)
        theta_pre = pre.theta[0]

        psi = theta_pre + (ry - theta_pre * rt) * rz / beta
        ate = float(psi.mean())
        se = float(psi.std(correction=1) / n ** 0.5)

        # the pseudo-outcome regression: one augmented-moments pass
        phi = cate_basis(X, cfg.cate_features)
        q = phi.shape[1]
        Gaug, _ = moments.weighted_gram(
            phi, torch.ones((n,), dtype=_F32, device=dev), append=psi,
            row_block=cfg.row_block, strategy=cfg.row_block_strategy)
        G = Gaug[:q, :q] + 1e-8 * n * torch.eye(q, dtype=_F32, device=dev)
        theta = det_solve(G, Gaug[:q, q])

        # the orthogonality diagnostic checks the moment that was zeroed:
        # the preliminary 2SLS solve's residual
        e = ry - theta_pre * rt
        diag = compute_iv_diagnostics(t, z, cf.oof_t, cf.oof_z, e)
        ctx = IVFitContext(y=y, t=t, z=z, XW=XW, phi=phi, seed=seed,
                           nuis_y=self.nuis_y, nuis_t=self.nuis_t,
                           nuis_z=self.nuis_z, compliance=self.compliance)
        return DRIVResult(ate=ate, stderr=se, theta=theta, pseudo=psi,
                          theta_pre=float(theta_pre), diagnostics=diag,
                          cfg=cfg, fit_ctx=ctx)
