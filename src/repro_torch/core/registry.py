"""The estimator registry: one record per estimator of the catalogue
(DML, DRLearner, the S/T/X metalearners, OrthoIV, DRIV), read by the
sweep engine and the effect store instead of private copies.

Each name of the JAX package's registry is registered here with its
base config and whether it needs an instrument, so the store's coverage
gate and the engine's per-column isolation decide as the reference's
do.  The DML family (``dml``, ``dml_p2_rb``, ``dml_loo``), the OrthoIV
family (``orthoiv``, ``orthoiv_p2_rb``), ``drlearner`` and ``driv``
have their ``fit`` and ``weighted_fit`` on the port's estimators; the
S/T/X metalearners raise ``NotImplementedError``: they land with the
mlp nuisance (ROADMAP A.6b), as does the conformance suite built on
them.

``weighted_fit(cfg)`` returns the weighted single fit the sweep masks
per segment: ``cell(folds, w, data)``, on given folds (torch cannot
replay the reference's fold keys; the bootstrap's replicates take their
folds the same way).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.dml import DML
from repro_torch.core.drlearner import DRLearner
from repro_torch.core.iv import DRIV, OrthoIV
from repro_torch.core.nuisance import make_logistic, make_nuisance, make_ridge

_LATER = "lands with the metalearners (ROADMAP A.6b)"


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """One estimator's registration.

    fit(data, cfg, gen)   -> the estimator's result (folds drawn on gen)
    point(result)         -> float ATE/LATE read off that result
    base_cfg              the estimator's canonical config
    weighted_fit(cfg)     -> cell(folds, w, data) -> {"theta", "se", "ate"}
                          the weighted single fit a sweep cell masks per
                          segment (w = segment mask)
    residual_fit(cfg)     -> resid(folds, w, data) -> residual dict (the
                          nuisance prefix of weighted_fit; None -> no
                          shared-nuisance reuse)
    final_fit(cfg)        -> final(resid, w, data) -> {"theta", ...}
    needs_instrument      whether the data must carry a ``z`` column
    """

    name: str
    fit: Callable[[Any, CausalConfig, torch.Generator], Any]
    point: Callable[[Any], float]
    base_cfg: CausalConfig
    weighted_fit: Optional[Callable[[CausalConfig], Callable]] = None
    residual_fit: Optional[Callable[[CausalConfig], Callable]] = None
    final_fit: Optional[Callable[[CausalConfig], Callable]] = None
    needs_instrument: bool = False


def nuisance_signature(cfg: CausalConfig) -> tuple:
    """The config fields that determine the nuisance stage — sweep cells
    whose configs agree on this tuple (differing only in final-stage
    fields like cate_features) can share one residual pass."""
    return (cfg.n_folds, cfg.nuisance_y, cfg.nuisance_t, cfg.nuisance_z,
            cfg.discrete_treatment, cfg.discrete_instrument,
            cfg.ridge_lambda, cfg.newton_iters, cfg.row_block,
            cfg.row_block_strategy, cfg.mlp_hidden, cfg.mlp_steps,
            cfg.mlp_lr, cfg.iv_cov_clip)


# -- DML --------------------------------------------------------------------

def _fit_dml(data, cfg, gen):
    return DML(cfg, device=data.X.device).fit(data.y, data.t, data.X, gen=gen)


def _dml_nuisances(cfg):
    t_task = "clf" if cfg.discrete_treatment else "reg"
    return (make_nuisance(cfg.nuisance_y, "reg", cfg),
            make_nuisance(cfg.nuisance_t, t_task, cfg))


def _dml_weighted_fit(cfg):
    from repro_torch.inference.bootstrap import dml_theta_once
    ny, nt = _dml_nuisances(cfg)

    def cell(folds, w, data):
        out = dml_theta_once(ny, nt, cfg.n_folds, data["X"], data["y"],
                             data["t"], data["phi"], folds, w, with_se=True,
                             row_block=cfg.row_block,
                             strategy=cfg.row_block_strategy)
        out["ate"] = out["theta"][..., 0]
        return out

    return cell


def _dml_residual_fit(cfg):
    from repro_torch.inference.bootstrap import (_batch, _unbatch,
                                                 dml_residuals_once)
    ny, nt = _dml_nuisances(cfg)

    def resid(folds, w, data):
        folds, w, single = _batch(folds, w)
        return _unbatch(dml_residuals_once(ny, nt, cfg.n_folds, data["X"],
                                           data["y"], data["t"], folds, w),
                        single)

    return resid


def _dml_final_fit(cfg):
    from repro_torch.inference.numerics import weighted_theta

    def final(resid, w, data):
        theta, se = weighted_theta(resid["ry"], resid["rt"], data["phi"], w,
                                   with_se=True, row_block=cfg.row_block,
                                   strategy=cfg.row_block_strategy)
        return {"theta": theta, "se": se, "ate": theta[..., 0]}

    return final


# -- orthogonal IV ------------------------------------------------------------

def _fit_orthoiv(data, cfg, gen):
    return OrthoIV(cfg, device=data.X.device).fit(data.y, data.t, data.z,
                                                 data.X, gen=gen)


def _iv_nuisances(cfg):
    est = OrthoIV(cfg, device="cpu")
    return est.nuis_y, est.nuis_t, est.nuis_z


def _orthoiv_weighted_fit(cfg):
    from repro_torch.inference.bootstrap import iv_theta_once
    ny, nt, nz = _iv_nuisances(cfg)

    def cell(folds, w, data):
        out = iv_theta_once(ny, nt, nz, cfg.n_folds, data["X"], data["y"],
                            data["t"], data["z"], data["phi"], folds, w,
                            with_se=True, row_block=cfg.row_block,
                            strategy=cfg.row_block_strategy)
        out["ate"] = out["theta"][..., 0]
        return out

    return cell


def _orthoiv_residual_fit(cfg):
    from repro_torch.inference.bootstrap import (_batch, _unbatch,
                                                 iv_residuals_once)
    ny, nt, nz = _iv_nuisances(cfg)

    def resid(folds, w, data):
        folds, w, single = _batch(folds, w)
        return _unbatch(iv_residuals_once(ny, nt, nz, cfg.n_folds, data["X"],
                                          data["y"], data["t"], data["z"],
                                          folds, w), single)

    return resid


def _orthoiv_final_fit(cfg):
    from repro_torch.inference.numerics import weighted_iv_theta

    def final(resid, w, data):
        theta, se = weighted_iv_theta(resid["ry"], resid["rt"], resid["rz"],
                                      data["phi"], w, with_se=True,
                                      row_block=cfg.row_block,
                                      strategy=cfg.row_block_strategy)
        return {"theta": theta, "se": se, "ate": theta[..., 0]}

    return final


# -- DRLearner ----------------------------------------------------------------

def _fit_dr(data, cfg, gen):
    return DRLearner(cfg, device=data.X.device).fit(data.y, data.t, data.X,
                                                    gen=gen)


def _dr_weighted_fit(cfg):
    from repro_torch.inference.bootstrap import dr_theta_once
    outcome = make_ridge(cfg.ridge_lambda, row_block=cfg.row_block,
                         strategy=cfg.row_block_strategy)
    propensity = make_logistic(cfg.ridge_lambda, cfg.newton_iters,
                               row_block=cfg.row_block,
                               strategy=cfg.row_block_strategy)

    def cell(folds, w, data):
        return dr_theta_once(outcome, propensity, cfg.n_folds, data["X"],
                             data["y"], data["t"], data["phi"], folds, w,
                             with_se=True, row_block=cfg.row_block,
                             strategy=cfg.row_block_strategy)

    return cell


# -- DRIV -------------------------------------------------------------------

def _fit_driv(data, cfg, gen):
    return DRIV(cfg, device=data.X.device).fit(data.y, data.t, data.z,
                                               data.X, gen=gen)


def _driv_weighted_fit(cfg):
    from repro_torch.inference.bootstrap import driv_theta_once
    ny, nt, nz = _iv_nuisances(cfg)
    compliance = make_ridge(cfg.ridge_lambda, row_block=cfg.row_block,
                            strategy=cfg.row_block_strategy)

    def cell(folds, w, data):
        return driv_theta_once(ny, nt, nz, compliance, cfg.n_folds,
                               data["X"], data["y"], data["t"], data["z"],
                               data["phi"], folds, w,
                               cov_clip=cfg.iv_cov_clip, with_se=True,
                               row_block=cfg.row_block,
                               strategy=cfg.row_block_strategy)

    return cell


# -- estimators of a later slice --------------------------------------------

def _later(name: str):
    def fit(*_args, **_kwargs):
        raise NotImplementedError(f"{name} is not ported yet; it {_LATER}")

    return fit


def _later_weighted(name: str):
    def build(cfg):
        raise NotImplementedError(f"{name}'s weighted fit is not ported "
                                  f"yet; it {_LATER}")

    return build


_CFG = CausalConfig(n_folds=3, inference="none")


def _spec(name, fit, point, cfg, iv=False, weighted_fit=None):
    if fit is None:
        return EstimatorSpec(name=name, fit=_later(name), point=_later(name),
                             base_cfg=cfg, weighted_fit=_later_weighted(name),
                             needs_instrument=iv)
    if weighted_fit is not None:
        # pseudo-outcome estimators: no shared-nuisance split
        return EstimatorSpec(name=name, fit=fit, point=point, base_cfg=cfg,
                             weighted_fit=weighted_fit, needs_instrument=iv)
    if iv:
        return EstimatorSpec(name=name, fit=fit, point=point, base_cfg=cfg,
                             weighted_fit=_orthoiv_weighted_fit,
                             residual_fit=_orthoiv_residual_fit,
                             final_fit=_orthoiv_final_fit,
                             needs_instrument=True)
    return EstimatorSpec(name=name, fit=fit, point=point, base_cfg=cfg,
                         weighted_fit=_dml_weighted_fit,
                         residual_fit=_dml_residual_fit,
                         final_fit=_dml_final_fit)


_ATE = lambda r: r.ate      # noqa: E731
_LATE = lambda r: r.late    # noqa: E731

SPECS = (
    _spec("dml", _fit_dml, _ATE, _CFG),
    _spec("dml_p2_rb", _fit_dml, _ATE,
          dataclasses.replace(_CFG, cate_features=2)),
    _spec("dml_loo", _fit_dml, _ATE,
          dataclasses.replace(_CFG, engine="parallel_loo")),
    _spec("drlearner", _fit_dr, _ATE, _CFG, weighted_fit=_dr_weighted_fit),
    _spec("s_learner", None, None, _CFG),
    _spec("t_learner", None, None, _CFG),
    _spec("x_learner", None, None, _CFG),
    _spec("orthoiv", _fit_orthoiv, _LATE, _CFG, iv=True),
    _spec("orthoiv_p2_rb", _fit_orthoiv, _LATE,
          dataclasses.replace(_CFG, cate_features=2), iv=True),
    _spec("driv", _fit_driv, _LATE, _CFG, iv=True,
          weighted_fit=_driv_weighted_fit),
)

SPEC_IDS = tuple(s.name for s in SPECS)

REGISTRY: Dict[str, EstimatorSpec] = {s.name: s for s in SPECS}


def get_spec(name: str) -> EstimatorSpec:
    """Registry lookup by estimator name (the sweep's and the store's
    entry point)."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown estimator {name!r}; registered: {sorted(REGISTRY)}"
        ) from None
