"""The estimator registry: one record per estimator of the catalogue
(DML, DRLearner, the S/T/X metalearners, OrthoIV, DRIV), read by the
conformance suite, the sweep engine and the effect store instead of
private copies.

Each name of the JAX package's registry is registered here with the
reference's base config, conformance data and tolerances, and whether it
needs an instrument, so the store's coverage gate and the engine's
per-column isolation decide as the reference's do.

``weighted_fit(cfg)`` returns the weighted single fit the sweep masks
per segment: ``cell(folds, w, data)``, on given folds (torch cannot
replay the reference's fold keys; the bootstrap's replicates take their
folds the same way).  The metalearners' cells ignore the folds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.dml import DML
from repro_torch.core.drlearner import DRLearner
from repro_torch.core.estimator import fit_adapter
from repro_torch.core.iv import DRIV, OrthoIV
from repro_torch.core.metalearners import (make_meta_core, s_learner,
                                           t_learner, x_learner)
from repro_torch.core.nuisance import make_logistic, make_nuisance, make_ridge
from repro_torch.data.causal_dgp import make_causal_data, make_iv_data

# Non-divisible on purpose: n % ROW_BLOCK != 0, so the zero-row padding
# of the blocked decomposition is exercised by every chunked ≡ whole
# assertion.
N_CONF = 1100
ROW_BLOCK = 256
EFFECT = 1.2


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """One estimator's registration with the conformance suite and the
    sweep.

    make_data(seed, device) -> the conformance data set
    fit(data, cfg, gen)   -> the estimator's result (folds drawn on gen)
    point(result)         -> float ATE/LATE read off that result
    truth(data)           -> the data's true ATE/LATE
    base_cfg              the estimator's canonical config
    boot(data, cfg, gen, executor, B) -> InferenceResult
    boot_cfg              the row-blocked config of the serial ≡ batched
                          check (None -> no bootstrap)
    truth_tol             |point - truth| bound of the truth check
    rb_tol                |point(rb=0) - point(rb=R)| tolerance
    weighted_fit(cfg)     -> cell(folds, w, data) -> {"theta", "ate", ...}
                          the weighted single fit a sweep cell masks per
                          segment (w = segment mask)
    residual_fit(cfg)     -> resid(folds, w, data) -> residual dict (the
                          nuisance prefix of weighted_fit; None -> no
                          shared-nuisance reuse)
    final_fit(cfg)        -> final(resid, w, data) -> {"theta", ...}
    needs_instrument      whether the data must carry a ``z`` column
    """

    name: str
    make_data: Callable[..., Any]
    fit: Callable[[Any, CausalConfig, torch.Generator], Any]
    point: Callable[[Any], float]
    truth: Callable[[Any], float]
    base_cfg: CausalConfig
    boot: Optional[Callable[..., Any]] = None
    boot_cfg: Optional[CausalConfig] = None
    truth_tol: float = 0.25
    rb_tol: float = 2e-3
    weighted_fit: Optional[Callable[[CausalConfig], Callable]] = None
    residual_fit: Optional[Callable[[CausalConfig], Callable]] = None
    final_fit: Optional[Callable[[CausalConfig], Callable]] = None
    needs_instrument: bool = False


def _conf_data(seed: int, device=None):
    return make_causal_data(N_CONF, 6, seed=seed, effect=EFFECT,
                            device=device)


def _conf_iv_data(seed: int, device=None):
    return make_iv_data(N_CONF, 6, seed=seed, effect=EFFECT,
                        compliance=0.75, device=device)


def _boot_via_inference(fit):
    """Estimators whose result exposes .inference(): one adapter."""

    def boot(data, cfg, gen, executor, n_replicates):
        return fit(data, cfg, gen).inference(executor=executor,
                                             n_bootstrap=n_replicates)

    return boot


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

_fit_dml = fit_adapter(DML, "y", "t", "X")


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

_fit_orthoiv = fit_adapter(OrthoIV, "y", "t", "z", "X")


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

_fit_dr = fit_adapter(DRLearner, "y", "t", "X")


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

_fit_driv = fit_adapter(DRIV, "y", "t", "z", "X")


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


# -- metalearners (weighted cores from core.metalearners; the cfg threads
#    row_block / strategy through the nuisance hypers) -----------------------

def _fit_meta(learner_fn):
    def fit(data, cfg, gen):
        return learner_fn(data.y, data.t, data.X, gen=gen, cfg=cfg,
                          device=data.X.device)

    return fit


def _meta_weighted_fit(learner: str):
    def build(cfg):
        core = make_meta_core(learner, cfg)

        def cell(folds, w, data):
            ate, _ = core(None, data["y"], data["t"], data["X"], w)
            return {"theta": ate[..., None], "ate": ate}

        return cell

    return build


_CFG = CausalConfig(n_folds=3, inference="none")
_CFG_BOOT_RB = CausalConfig(n_folds=3, n_bootstrap=4, row_block=ROW_BLOCK)
_ATE = lambda r: r.ate                   # noqa: E731
_LATE = lambda r: r.late                 # noqa: E731
_TRUE_ATE = lambda d: d.true_ate         # noqa: E731
_TRUE_LATE = lambda d: d.true_late       # noqa: E731


def _dml_spec(name, cfg, boot_cfg=None, **kw):
    return EstimatorSpec(
        name=name, make_data=_conf_data, fit=_fit_dml, point=_ATE,
        truth=_TRUE_ATE, base_cfg=cfg,
        boot=_boot_via_inference(_fit_dml) if boot_cfg else None,
        boot_cfg=boot_cfg, weighted_fit=_dml_weighted_fit,
        residual_fit=_dml_residual_fit, final_fit=_dml_final_fit, **kw)


def _meta_spec(learner: str, learner_fn):
    fit = _fit_meta(learner_fn)
    return EstimatorSpec(
        name=f"{learner}_learner", make_data=_conf_data, fit=fit,
        point=_ATE, truth=_TRUE_ATE, base_cfg=_CFG,
        boot=_boot_via_inference(fit), boot_cfg=_CFG_BOOT_RB,
        weighted_fit=_meta_weighted_fit(learner))


def _iv_spec(name, fit, cfg, boot_cfg, truth_tol, **kw):
    return EstimatorSpec(
        name=name, make_data=_conf_iv_data, fit=fit, point=_LATE,
        truth=_TRUE_LATE, base_cfg=cfg, boot=_boot_via_inference(fit),
        boot_cfg=boot_cfg, truth_tol=truth_tol, needs_instrument=True, **kw)


def _orthoiv_spec(name, cfg, boot_cfg, truth_tol):
    return _iv_spec(name, _fit_orthoiv, cfg, boot_cfg, truth_tol,
                    weighted_fit=_orthoiv_weighted_fit,
                    residual_fit=_orthoiv_residual_fit,
                    final_fit=_orthoiv_final_fit)


SPECS = (
    _dml_spec("dml", _CFG, _CFG_BOOT_RB),
    # theta[0] is the x = 0 effect under the [1, x0] basis
    _dml_spec("dml_p2_rb", dataclasses.replace(_CFG, cate_features=2),
              dataclasses.replace(_CFG_BOOT_RB, cate_features=2),
              truth_tol=0.4),
    _dml_spec("dml_loo", dataclasses.replace(_CFG, engine="parallel_loo")),
    EstimatorSpec(
        name="drlearner", make_data=_conf_data, fit=_fit_dr, point=_ATE,
        truth=_TRUE_ATE, base_cfg=_CFG, boot=_boot_via_inference(_fit_dr),
        boot_cfg=_CFG_BOOT_RB, weighted_fit=_dr_weighted_fit),
    _meta_spec("s", s_learner),
    _meta_spec("t", t_learner),
    _meta_spec("x", x_learner),
    # IV variance at n = 1100 is wide
    _orthoiv_spec("orthoiv", _CFG, _CFG_BOOT_RB, 0.35),
    _orthoiv_spec("orthoiv_p2_rb", dataclasses.replace(_CFG, cate_features=2),
                  dataclasses.replace(_CFG_BOOT_RB, cate_features=2), 0.5),
    _iv_spec("driv", _fit_driv, _CFG, _CFG_BOOT_RB, 0.35,
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


def _to_tree(obj):
    """Dataclass results opened into plain dicts (caches, configs and fit
    contexts left out), so ``tree_arrays`` reaches every nested tensor."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if not f.name.startswith("_")
                and f.name not in ("cfg", "fit_ctx")}
    return obj


def tree_arrays(tree) -> tuple:
    """The floating tensor leaves of an estimator result, in a fixed
    order, for exact-equality comparison across execution strategies."""
    from repro_torch.inference.executor import tree_leaves

    return tuple(leaf for leaf in tree_leaves(_to_tree(tree))
                 if isinstance(leaf, torch.Tensor)
                 and leaf.dtype.is_floating_point)
