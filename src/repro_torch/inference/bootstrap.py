"""Bootstrap re-estimation as batched programs.

EconML's ``BootstrapInference(n_bootstrap_samples=B)`` re-runs the
whole estimator B times — the step the paper hands to Ray.  Here each
replicate is a *weighted* refit (pairs bootstrap: multinomial row
counts; multiplier / Bayesian: Exp(1) row weights): the replicate
weights multiply the fold-complement masks, and a (R, k, n) weight
tensor turns R re-estimations into one batched fit whose every Gram is
one launch of the segment-Gram kernel on the card.

Replay: replicate b draws its weights, then its folds, then the inits
of any mlp refit, from its own generator, seeded from ``(seed, b)``
alone (``replicate_generators``), so a B=100 run is a prefix of a B=200
run and any replicate can be replayed alone.  The generators are CPU generators, so the draws do not
depend on the device the fit runs on.  torch cannot replay
``jax.random``: ``dml_theta_once`` / ``iv_theta_once`` /
``dr_theta_once`` / ``driv_theta_once`` take folds and weights
explicitly, which is how the tests feed both packages the same draws.

The doubly-robust refits (``dr_*``, ``driv_*``) also draw the ATE / LATE
functional itself — the weighted mean pseudo-outcome, which is not
theta[0] outside the constant basis — into the result's
``ate_replicates``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.crossfit import (_oof_select, _stack_states, fold_ids,
                                       fold_weights)
from repro_torch.core.nuisance import Nuisance
from repro_torch.draws import (bootstrap_weights, derive_seed,  # noqa: F401
                               replicate_generator, replicate_generators,
                               replicate_weights)
from repro_torch.inference.executor import tree_map
from repro_torch.inference.intervals import InferenceResult
from repro_torch.inference.numerics import (logistic_fit_folds_w,
                                            predict_folds_linear,
                                            predict_folds_logistic,
                                            ridge_fit_folds_w,
                                            weighted_iv_theta,
                                            weighted_theta)

Tensor = torch.Tensor
_F32 = torch.float32

SCHEMES = ("pairs", "multiplier", "bayesian")


def replicate_draws(seed: int, ids: Tensor, n: int, n_folds: int,
                    scheme: str, device=None):
    """(folds (R, n), w (R, n), gens) of the replicates ``ids``: each
    draws its weights, then its fold assignment, from its own generator;
    ``gens`` go on to draw its mlp refits' inits."""
    w, gens = replicate_weights(seed, ids, n, scheme, device)
    folds = torch.stack([fold_ids(g, n, n_folds) for g in gens])
    return folds.to(device), w, gens


def _hyper(nuis: Nuisance, name: str, default):
    return (nuis.hyper or {}).get(name, default)


def init_states(nuis: Nuisance, gens: Optional[Sequence[torch.Generator]],
                rows: int, per_row: int, p: int, device) -> Dict:
    """rows × per_row init states of ``nuis`` on one leading axis, row
    by row: row r draws its per_row models in turn on ``gens[r]`` (one
    generator may stand for one row); with no generators each row draws
    on a generator of its own seeded 0.  A model's init so depends on
    its row's generator alone, never on the batch the row sits in."""
    if gens is None:
        gens = [torch.Generator().manual_seed(0) for _ in range(rows)]
    elif isinstance(gens, torch.Generator):
        gens = [gens]
    if len(gens) != rows:
        raise ValueError(f"{len(gens)} generators for {rows} rows")
    return _stack_states([nuis.init(g, p, device) for g in gens
                          for _ in range(per_row)])


def fit_predict_folds(nuis: Nuisance, X: Tensor, target: Tensor,
                      Wk: Tensor,
                      gens: Optional[Sequence[torch.Generator]] = None
                      ) -> Tensor:
    """(…, k, n) fold-model predictions under the weights ``Wk``
    (…, k, n), through the fold-and-replicate batched ridge / logistic
    fits.  Their Grams take the row_block and strategy the nuisance was
    built with (its ``hyper``): on the card under "pallas" each is one
    launch of the kernel for the whole batch.  Any other nuisance (the
    mlp) fits every (…, k) model in one batched ``nuis.fit``; replicate
    r of the leading axes draws its k fold inits in turn on ``gens[r]``
    (``init_states``; one generator for a (k, n) ``Wk``), as the
    reference draws each fold's init from the replicate's key."""
    rb = int(_hyper(nuis, "row_block", 0))
    st = _hyper(nuis, "strategy", None)
    lam = _hyper(nuis, "lam", 1e-3)
    if nuis.name == "ridge":
        return predict_folds_linear(
            ridge_fit_folds_w(lam, X, target, Wk, row_block=rb, strategy=st),
            X)
    if nuis.name == "logistic":
        iters = int(_hyper(nuis, "iters", 16))
        return predict_folds_logistic(
            logistic_fit_folds_w(lam, iters, X, target, Wk, row_block=rb,
                                 strategy=st), X)
    if target.dim() == 2:                 # a target per replicate
        target = target[:, None, :].expand(Wk.shape)
    lead = tuple(Wk.shape[:-1])
    state = init_states(nuis, gens, math.prod(lead[:-1]), lead[-1],
                        X.shape[1], X.device)
    state = tree_map(lambda x: x.reshape(lead + tuple(x.shape[1:])), state)
    state = nuis.fit(state, X, target, Wk)
    return nuis.predict(state, X)


def _rows(target: Tensor) -> Tensor:
    """A target as (1, n), or its own (R, n) rows when it has one per
    replicate (the refuters' permuted treatments and instruments)."""
    target = target.to(_F32)
    return target if target.dim() == 2 else target[None]


def _batch(folds: Tensor, w: Tensor):
    """(folds, w) with a leading replicate axis, and whether to drop it."""
    single = folds.dim() == 1
    return (folds[None], w[None], single) if single else (folds, w, single)


def _unbatch(out: Dict[str, Tensor], single: bool) -> Dict[str, Tensor]:
    return {key: v[0] for key, v in out.items()} if single else out


def dml_residuals_once(nuis_y: Nuisance, nuis_t: Nuisance, n_folds: int,
                       XW: Tensor, y: Tensor, t: Tensor, folds: Tensor,
                       w: Tensor, gens=None) -> Dict[str, Tensor]:
    """The nuisance prefix of weighted DML re-estimations: both
    nuisances cross-fit under ``fold_weights(folds) * w`` for each
    replicate of the (R, n) folds and weights; returns the orthogonal
    residuals {ry, rt}, each (R, n).  y and t are (n,), or (R, n) with a
    target per replicate.  ``gens`` (one a replicate) draw the mlp
    refits' inits, y's then t's (``fit_predict_folds``)."""
    Wk = fold_weights(folds, n_folds) * w[:, None, :].to(_F32)
    oof_y = _oof_select(fit_predict_folds(nuis_y, XW, y, Wk, gens), folds)
    oof_t = _oof_select(fit_predict_folds(nuis_t, XW, t, Wk, gens), folds)
    return {"ry": _rows(y) - oof_y, "rt": _rows(t) - oof_t}


def dml_theta_once(nuis_y: Nuisance, nuis_t: Nuisance, n_folds: int,
                   XW: Tensor, y: Tensor, t: Tensor, phi: Tensor,
                   folds: Tensor, w: Tensor, *, with_se: bool = True,
                   row_block: int = 0, strategy: Optional[str] = None,
                   gens=None) -> Dict[str, Tensor]:
    """Full weighted DML re-estimations on given folds and weights,
    (n,) or (R, n): nuisances cross-fit under ``fold_weights * w``, then
    the weighted orthogonal final stage at ``row_block`` / ``strategy``.
    Returns {theta[, se]}, each (p_phi,) or (R, p_phi)."""
    folds, w, single = _batch(folds, w)
    r = dml_residuals_once(nuis_y, nuis_t, n_folds, XW, y, t, folds, w,
                           gens)
    theta, se = weighted_theta(r["ry"], r["rt"], phi, w, with_se=with_se,
                               row_block=row_block, strategy=strategy)
    out = {"theta": theta} if se is None else {"theta": theta, "se": se}
    return _unbatch(out, single)


def make_dml_replicate_fn(nuis_y: Nuisance, nuis_t: Nuisance, n_folds: int,
                          *, seed: int, scheme: str = "pairs",
                          with_se: bool = True, row_block: int = 0,
                          strategy: Optional[str] = None):
    """The bootstrap replicate function for an executor:
    (ids, XW, y, t, phi) -> {theta[, se]} with a leading len(ids)."""

    def replicate(ids, XW, y, t, phi):
        folds, w, gens = replicate_draws(seed, ids, XW.shape[0], n_folds,
                                         scheme, device=XW.device)
        return dml_theta_once(nuis_y, nuis_t, n_folds, XW, y, t, phi, folds,
                              w, with_se=with_se, row_block=row_block,
                              strategy=strategy, gens=gens)

    return replicate


def _run(replicate, n_replicates: int, label: str, args, *, executor,
         memory_budget: int, chunk: int, max_retries: int, tracer):
    """The B replicates as one map of the task runtime over the ids
    0 .. B-1: chunked (``chunk``, or the memory model against
    ``memory_budget``), each chunk retried down the backend ladder."""
    from repro_torch.runtime import as_runtime
    rt = as_runtime(executor, memory_budget=memory_budget, chunk=chunk,
                    max_retries=max_retries, tracer=tracer)
    ids = torch.arange(n_replicates)
    return rt.map(replicate, ids, *args, label=label), rt.name


def _result(out, scheme, exe_name, point, point_se, alpha,
            ate_point: Optional[float] = None) -> InferenceResult:
    thetas = out["theta"]
    return InferenceResult(
        method=scheme, executor=exe_name,
        point=thetas.mean(dim=0) if point is None else point,
        replicates=thetas, se=torch.std(thetas, dim=0, correction=1),
        alpha=alpha, point_se=point_se, replicate_se=out.get("se"),
        ate_replicates=out.get("ate"), ate_point=ate_point)


def dml_bootstrap(nuis_y: Nuisance, nuis_t: Nuisance, *, n_folds: int,
                  XW: Tensor, y: Tensor, t: Tensor, phi: Tensor, seed: int,
                  n_replicates: int = 200, scheme: str = "pairs",
                  executor="vmap", alpha: float = 0.05,
                  with_se: bool = True, point: Optional[Tensor] = None,
                  point_se: Optional[Tensor] = None, row_block: int = 0,
                  strategy: Optional[str] = None, memory_budget: int = 0,
                  chunk: int = 0, max_retries: int = 2,
                  tracer=None) -> InferenceResult:
    """B weighted DML refits scheduled by the task runtime
    (``repro_torch.runtime``): ``executor`` a name, Executor or
    TaskRuntime; ``chunk`` replicates per batched call (0: all, or the
    memory model's chunk under ``memory_budget``); each chunk retries
    down the backend ladder up to ``max_retries`` times.
    Replicate-ordered, bitwise the same at any chunking."""
    replicate = make_dml_replicate_fn(nuis_y, nuis_t, n_folds, seed=seed,
                                      scheme=scheme, with_se=with_se,
                                      row_block=row_block, strategy=strategy)
    out, name = _run(replicate, n_replicates, "dml_bootstrap",
                     (XW, y, t, phi), executor=executor,
                     memory_budget=memory_budget, chunk=chunk,
                     max_retries=max_retries, tracer=tracer)
    return _result(out, scheme, name, point, point_se, alpha)


def iv_residuals_once(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance,
                      n_folds: int, XW: Tensor, y: Tensor, t: Tensor,
                      z: Tensor, folds: Tensor, w: Tensor, gens=None
                      ) -> Dict[str, Tensor]:
    """The nuisance prefix of weighted OrthoIV re-estimations: the three
    nuisances cross-fit under ``fold_weights(folds) * w``; returns
    {ry, rt, rz}, each (R, n).  ``gens`` as ``dml_residuals_once``."""
    Wk = fold_weights(folds, n_folds) * w[:, None, :].to(_F32)
    r = {}
    for key, nuis, target in (("ry", nuis_y, y), ("rt", nuis_t, t),
                              ("rz", nuis_z, z)):
        oof = _oof_select(fit_predict_folds(nuis, XW, target, Wk, gens),
                          folds)
        r[key] = _rows(target) - oof
    return r


def iv_theta_once(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance,
                  n_folds: int, XW: Tensor, y: Tensor, t: Tensor, z: Tensor,
                  phi: Tensor, folds: Tensor, w: Tensor, *,
                  with_se: bool = True, row_block: int = 0,
                  strategy: Optional[str] = None, gens=None
                  ) -> Dict[str, Tensor]:
    """Full weighted OrthoIV re-estimations on given folds and weights,
    (n,) or (R, n): three weighted nuisance cross-fits, then the weighted
    instrumented final stage.  Returns {theta[, se]}."""
    folds, w, single = _batch(folds, w)
    r = iv_residuals_once(nuis_y, nuis_t, nuis_z, n_folds, XW, y, t, z,
                          folds, w, gens)
    theta, se = weighted_iv_theta(r["ry"], r["rt"], r["rz"], phi, w,
                                  with_se=with_se, row_block=row_block,
                                  strategy=strategy)
    out = {"theta": theta} if se is None else {"theta": theta, "se": se}
    return _unbatch(out, single)


def iv_bootstrap(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance, *,
                 n_folds: int, XW: Tensor, y: Tensor, t: Tensor, z: Tensor,
                 phi: Tensor, seed: int, n_replicates: int = 200,
                 scheme: str = "pairs", executor="vmap",
                 alpha: float = 0.05, with_se: bool = True,
                 point: Optional[Tensor] = None,
                 point_se: Optional[Tensor] = None, row_block: int = 0,
                 strategy: Optional[str] = None, memory_budget: int = 0,
                 chunk: int = 0, max_retries: int = 2,
                 tracer=None) -> InferenceResult:
    """B weighted OrthoIV refits, scheduled as ``dml_bootstrap``."""

    def replicate(ids, XW_, y_, t_, z_, phi_):
        folds, w, gens = replicate_draws(seed, ids, XW_.shape[0], n_folds,
                                         scheme, device=XW_.device)
        return iv_theta_once(nuis_y, nuis_t, nuis_z, n_folds, XW_, y_, t_,
                             z_, phi_, folds, w, with_se=with_se,
                             row_block=row_block, strategy=strategy,
                             gens=gens)

    out, name = _run(replicate, n_replicates, "iv_bootstrap",
                     (XW, y, t, z, phi), executor=executor,
                     memory_budget=memory_budget, chunk=chunk,
                     max_retries=max_retries, tracer=tracer)
    return _result(out, scheme, name, point, point_se, alpha)


# ---------------------------------------------------------------------------
# The doubly-robust refits: DRLearner (AIPW) and DRIV.
# ---------------------------------------------------------------------------

def _weighted_mean_rows(w: Tensor, psi: Tensor) -> Tensor:
    """(R,) ``Σ w·psi / max(Σ w, 1)`` per replicate row, each row reduced
    alone: a reduction over a (R, n) tensor may split its rows another
    way at another R, and a replicate's bits must not depend on the
    batch it sits in."""
    wf = w.to(_F32)
    return torch.stack([(wf[b] * psi[b]).sum()
                        / torch.clamp(wf[b].sum(), min=1.0)
                        for b in range(psi.shape[0])])


def dr_theta_once(outcome: Nuisance, propensity: Nuisance, n_folds: int,
                  X: Tensor, y: Tensor, t: Tensor, phi: Tensor,
                  folds: Tensor, w: Tensor, *, clip: float = 0.01,
                  with_se: bool = True, row_block: int = 0,
                  strategy: Optional[str] = None, gens=None
                  ) -> Dict[str, Tensor]:
    """Weighted AIPW re-estimations (mirrors ``DRLearner.fit``) on given
    folds and weights, (n,) or (R, n): both arms' outcome models under
    ``fold_weights * arm * w`` and the propensity under
    ``fold_weights * w`` (fold-and-replicate batched fits), the clipped
    AIPW pseudo-outcome, then the weighted pseudo-outcome regression on
    phi.  Returns {theta, ate[, se]}: theta (p_phi,) or (R, p_phi), ate
    the weighted mean pseudo-outcome."""
    folds, w, single = _batch(folds, w)
    W = fold_weights(folds, n_folds)                    # (R, k, n)
    tt = t.to(_F32)
    yy = y.to(_F32)[None]
    wk = w[:, None, :].to(_F32)
    m0 = _oof_select(fit_predict_folds(outcome, X, y,
                                       W * (1.0 - tt) * wk, gens), folds)
    m1 = _oof_select(fit_predict_folds(outcome, X, y, W * tt * wk, gens),
                     folds)
    e = _oof_select(fit_predict_folds(propensity, X, tt, W * wk, gens),
                    folds)
    e = torch.clamp(e, clip, 1.0 - clip)
    psi = (m1 - m0 + tt * (yy - m1) / e
           - (1.0 - tt) * (yy - m0) / (1.0 - e))
    theta, se = weighted_theta(psi, torch.ones_like(psi), phi, w,
                               with_se=with_se, row_block=row_block,
                               strategy=strategy)
    out = {"theta": theta, "ate": _weighted_mean_rows(w, psi)}
    if se is not None:
        out["se"] = se
    return _unbatch(out, single)


def dr_bootstrap(outcome: Nuisance, propensity: Nuisance, *, n_folds: int,
                 X: Tensor, y: Tensor, t: Tensor, phi: Tensor, seed: int,
                 n_replicates: int = 200, scheme: str = "pairs",
                 executor="vmap", alpha: float = 0.05, clip: float = 0.01,
                 with_se: bool = True, point: Optional[Tensor] = None,
                 point_se: Optional[Tensor] = None,
                 ate_point: Optional[float] = None, row_block: int = 0,
                 strategy: Optional[str] = None, memory_budget: int = 0,
                 chunk: int = 0, max_retries: int = 2,
                 tracer=None) -> InferenceResult:
    """B weighted AIPW refits, scheduled as ``dml_bootstrap``; the ATE
    functional's own draws fill ``ate_replicates``."""

    def replicate(ids, X_, y_, t_, phi_):
        folds, w, gens = replicate_draws(seed, ids, X_.shape[0], n_folds,
                                         scheme, device=X_.device)
        return dr_theta_once(outcome, propensity, n_folds, X_, y_, t_, phi_,
                             folds, w, clip=clip, with_se=with_se,
                             row_block=row_block, strategy=strategy,
                             gens=gens)

    out, name = _run(replicate, n_replicates, "dr_bootstrap", (X, y, t, phi),
                     executor=executor, memory_budget=memory_budget,
                     chunk=chunk, max_retries=max_retries, tracer=tracer)
    return _result(out, scheme, name, point, point_se, alpha, ate_point)


def driv_theta_once(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance,
                    compliance: Nuisance, n_folds: int, XW: Tensor,
                    y: Tensor, t: Tensor, z: Tensor, phi: Tensor,
                    folds: Tensor, w: Tensor, *, cov_clip: float = 0.1,
                    with_se: bool = True, row_block: int = 0,
                    strategy: Optional[str] = None, gens=None
                    ) -> Dict[str, Tensor]:
    """Weighted DRIV re-estimations (mirrors ``DRIV.fit``) on given folds
    and weights, (n,) or (R, n): the three residual nuisances and the
    compliance β(x) = E[rt·rz|X] under ``fold_weights * w``, the
    preliminary weighted constant OrthoIV, the pseudo-outcome
    ψ = θ_pre + (ry - θ_pre·rt)·rz / clip(β), then its weighted
    regression on phi.  Returns {theta, ate[, se]}, ate the weighted
    mean ψ (the LATE functional).

    The compliance target rt·rz differs per replicate, so its fold fit
    runs one replicate at a time (each one fold-batched fit)."""
    from repro_torch.core.iv import clip_compliance
    folds, w, single = _batch(folds, w)
    r = iv_residuals_once(nuis_y, nuis_t, nuis_z, n_folds, XW, y, t, z,
                          folds, w, gens)
    ry, rt, rz = r["ry"], r["rt"], r["rz"]
    Wk = fold_weights(folds, n_folds) * w[:, None, :].to(_F32)
    target = rt * rz
    preds = torch.stack([fit_predict_folds(
        compliance, XW, target[b], Wk[b],
        None if gens is None else gens[b:b + 1])
        for b in range(target.shape[0])])
    beta = clip_compliance(_oof_select(preds, folds), cov_clip)
    ones = torch.ones((XW.shape[0], 1), dtype=_F32, device=XW.device)
    th_pre, _ = weighted_iv_theta(ry, rt, rz, ones, w, with_se=False,
                                  row_block=row_block, strategy=strategy)
    th0 = th_pre[:, :1]
    psi = th0 + (ry - th0 * rt) * rz / beta
    theta, se = weighted_theta(psi, torch.ones_like(psi), phi, w,
                               with_se=with_se, row_block=row_block,
                               strategy=strategy)
    out = {"theta": theta, "ate": _weighted_mean_rows(w, psi)}
    if se is not None:
        out["se"] = se
    return _unbatch(out, single)


def driv_bootstrap(nuis_y: Nuisance, nuis_t: Nuisance, nuis_z: Nuisance,
                   compliance: Nuisance, *, n_folds: int, XW: Tensor,
                   y: Tensor, t: Tensor, z: Tensor, phi: Tensor, seed: int,
                   n_replicates: int = 200, scheme: str = "pairs",
                   executor="vmap", alpha: float = 0.05,
                   cov_clip: float = 0.1, with_se: bool = True,
                   point: Optional[Tensor] = None,
                   point_se: Optional[Tensor] = None,
                   ate_point: Optional[float] = None, row_block: int = 0,
                   strategy: Optional[str] = None, memory_budget: int = 0,
                   chunk: int = 0, max_retries: int = 2,
                   tracer=None) -> InferenceResult:
    """B weighted DRIV refits, scheduled as ``dml_bootstrap``; the LATE
    functional's own draws fill ``ate_replicates``."""

    def replicate(ids, XW_, y_, t_, z_, phi_):
        folds, w, gens = replicate_draws(seed, ids, XW_.shape[0], n_folds,
                                         scheme, device=XW_.device)
        return driv_theta_once(nuis_y, nuis_t, nuis_z, compliance, n_folds,
                               XW_, y_, t_, z_, phi_, folds, w,
                               cov_clip=cov_clip, with_se=with_se,
                               row_block=row_block, strategy=strategy,
                               gens=gens)

    out, name = _run(replicate, n_replicates, "driv_bootstrap",
                     (XW, y, t, z, phi), executor=executor,
                     memory_budget=memory_budget, chunk=chunk,
                     max_retries=max_retries, tracer=tracer)
    return _result(out, scheme, name, point, point_se, alpha, ate_point)
