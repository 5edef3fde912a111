"""Metalearners (Künzel et al. 2019) — the S/T/X baselines the paper
cites in §2.2 — on the card, over the same weighted fits as the
bootstrap.

  S-learner: one model of E[Y | X, T];  τ(x) = f(x, 1) - f(x, 0)
  T-learner: per-arm models;            τ(x) = m1(x) - m0(x)
  X-learner: imputed per-arm effects blended by the propensity

    res = x_learner(y, t, X, cfg=CausalConfig(row_block=4096,
                                               row_block_strategy="pallas"))
    res.ate, res.cate, res.ate_interval()

Every learner body is a *weighted* core ``(gen, y, t, X, w) -> (ate,
cate)``: the public fits run it at w = 1, bootstrap replicates
(``meta_bootstrap``) at resampling weights, and the sweep's cells at
per-segment masks.  ``w`` may be (n,) or (R, n): ridge and logistic
stages go through the fold-and-replicate batched fits of
``repro_torch.inference.numerics`` with a singleton fold axis (weights
(R, 1, n)), so each weighted Gram of a chunk of replicates is one
fold_weighted launch of the segment-Gram kernel under
``strategy="pallas"`` on the card, and a replicate's numbers do not
depend on the batch it sits in.  The X-learner's stage-2 targets differ
per replicate, so those two ridge fits run one replicate at a time.
Other nuisances (the mlp) fit through ``nuis.fit`` from the states
``init`` draws: on ``gen`` for w (n,), and for w (R, n) row r's on
``gen[r]``, one generator a row (ridge and logistic ignore it).  Each
stage draws its inits in turn, as the reference splits its key.

The stages take the nuisance's ``strategy`` hyper as well as its
``row_block``; the reference passes only ``row_block``, so there the
plain chunked forms run.

Fits return ``MetaResult`` (an ``EffectResult``) with ``ate_interval``
over B weighted learner refits; the CATE is not linear in a phi basis,
so only the ATE functional has replicate intervals.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.estimator import (EffectResult, inf_cache_field,
                                        resolve_scheme)
from repro_torch.core.nuisance import Nuisance, make_logistic, make_ridge
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.draws import derive_seed, replicate_weights

if TYPE_CHECKING:
    from repro_torch.inference.intervals import InferenceResult

Tensor = torch.Tensor
_F32 = torch.float32


def _hyper(nuis: Nuisance, name: str, default):
    return (nuis.hyper or {}).get(name, default)


def _wfit_predict(nuis: Nuisance, gen, X: Tensor, target: Tensor,
                  w: Tensor) -> Callable[[Tensor], Tensor]:
    """A weighted fit -> its predict callable, (n,) or (R, n) per row of
    ``w``.  Ridge and logistic take the batched weighted fits with a
    singleton fold axis; other nuisances fit through ``nuis.fit`` from
    the init ``gen`` draws (w (n,): a generator or None) or, for w
    (R, n), row r's on ``gen[r]`` (``init_states``; None: seed 0)."""
    from repro_torch.inference.bootstrap import init_states
    from repro_torch.inference.numerics import (logistic_fit_folds_w,
                                                predict_folds_linear,
                                                predict_folds_logistic,
                                                ridge_fit_folds_w)
    rb = int(_hyper(nuis, "row_block", 0))
    st = _hyper(nuis, "strategy", None)
    Wk = w[..., None, :]
    if nuis.name == "ridge":
        beta = ridge_fit_folds_w(_hyper(nuis, "lam", 1e-3), X, target, Wk,
                                 row_block=rb, strategy=st)
        return lambda Xe: predict_folds_linear(beta, Xe)[..., 0, :]
    if nuis.name == "logistic":
        beta = logistic_fit_folds_w(_hyper(nuis, "lam", 1e-3),
                                    int(_hyper(nuis, "iters", 16)), X,
                                    target, Wk, row_block=rb, strategy=st)
        return lambda Xe: predict_folds_logistic(beta, Xe)[..., 0, :]
    if w.dim() == 2:
        state = init_states(nuis, gen, w.shape[0], 1, X.shape[1], X.device)
    else:
        state = nuis.init(gen, X.shape[1], X.device)
    state = nuis.fit(state, X, target, w)
    return lambda Xe: nuis.predict(state, Xe)


def _wmean(x: Tensor, w: Tensor) -> Tensor:
    """``Σ w·x / max(Σ w, 1)``: a scalar, or (R,) with each row reduced
    alone."""
    if w.dim() == 2:
        from repro_torch.inference.bootstrap import _weighted_mean_rows
        return _weighted_mean_rows(w, x)
    wf = w.to(_F32)
    return (wf * x).sum() / torch.clamp(wf.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Weighted learner cores: (gen, y, t, X, w) -> (ate, cate).
# ---------------------------------------------------------------------------

def _s_core(nuis, gen, y, t, X, w):
    tt = t.to(_F32)[:, None]
    Xt = torch.cat([X, tt, X * tt], dim=1)       # treatment interactions
    predict = _wfit_predict(nuis, gen, Xt, y, w)
    # each copy is (n, 2p + 1): at 1M × 500 4 GB, so one lives at a time
    del Xt
    X1 = torch.cat([X, torch.ones_like(tt), X], dim=1)
    m1 = predict(X1)
    del X1
    X0 = torch.cat([X, torch.zeros_like(tt), torch.zeros_like(X)], dim=1)
    cate = m1 - predict(X0)
    return _wmean(cate, w), cate


def _t_core(nuis, gen, y, t, X, w):
    tt = t.to(_F32)
    m1 = _wfit_predict(nuis, gen, X, y, w * tt)(X)
    m0 = _wfit_predict(nuis, gen, X, y, w * (1.0 - tt))(X)
    cate = m1 - m0
    return _wmean(cate, w), cate


def _x_core(nuis, prop, gen, y, t, X, w, clip):
    tt = t.to(_F32)
    # stage 1: per-arm outcome models
    m1 = _wfit_predict(nuis, gen, X, y, w * tt)(X)
    m0 = _wfit_predict(nuis, gen, X, y, w * (1.0 - tt))(X)
    # stage 2: imputed individual effects, learned per arm (a target per
    # replicate: these ridge fits run one replicate at a time)
    tau1 = _wfit_predict(nuis, gen, X, y - m0, w * tt)(X)
    tau0 = _wfit_predict(nuis, gen, X, m1 - y, w * (1.0 - tt))(X)
    # stage 3: propensity-weighted blend
    e = torch.clamp(_wfit_predict(prop, gen, X, tt, w)(X), clip, 1.0 - clip)
    cate = e * tau0 + (1.0 - e) * tau1
    return _wmean(cate, w), cate


def make_meta_core(learner: str, cfg: Optional[CausalConfig] = None,
                   nuisance: Optional[Nuisance] = None,
                   propensity: Optional[Nuisance] = None,
                   clip: float = 0.01) -> Callable:
    """One learner's weighted core ``(gen, y, t, X, w) -> (ate, cate)``,
    with ridge / logistic nuisances built from the config's ``row_block``
    and ``row_block_strategy`` unless given."""
    cfg = cfg or CausalConfig()
    nuis = nuisance or make_ridge(cfg.ridge_lambda, row_block=cfg.row_block,
                                  strategy=cfg.row_block_strategy)
    if learner == "s":
        return lambda gen, y, t, X, w: _s_core(nuis, gen, y, t, X, w)
    if learner == "t":
        return lambda gen, y, t, X, w: _t_core(nuis, gen, y, t, X, w)
    if learner == "x":
        prop = propensity or make_logistic(cfg.ridge_lambda,
                                           cfg.newton_iters,
                                           row_block=cfg.row_block,
                                           strategy=cfg.row_block_strategy)
        return lambda gen, y, t, X, w: _x_core(nuis, prop, gen, y, t, X, w,
                                               clip)
    raise ValueError(f"unknown metalearner {learner!r} (expected s|t|x)")


# ---------------------------------------------------------------------------
# Replicate inference: B weighted learner refits through the task runtime.
# ---------------------------------------------------------------------------

def meta_bootstrap(core: Callable, *, y: Tensor, t: Tensor, X: Tensor,
                   seed: int, n_replicates: int = 200,
                   scheme: str = "pairs", executor="vmap",
                   alpha: float = 0.05, ate_point: Optional[float] = None,
                   memory_budget: int = 0, chunk: int = 0,
                   max_retries: int = 2, tracer=None) -> InferenceResult:
    """B weighted metalearner refits through the task runtime (chunked,
    fault-tolerant, replicate-ordered, as ``dml_bootstrap``).  Replicate
    b draws its weights, then its nuisances' inits, on its own generator
    (``replicate_weights``).  Only the ATE functional's draws are kept:
    the metalearners' CATEs are not linear in a phi basis."""
    from repro_torch.inference.bootstrap import _result, _run

    def replicate(ids, y_, t_, X_):
        w, gens = replicate_weights(seed, ids, X_.shape[0], scheme,
                                    device=X_.device)
        ate, _ = core(gens, y_, t_, X_, w)
        return {"ate": ate}

    out, name = _run(replicate, n_replicates, "meta_bootstrap", (y, t, X),
                     executor=executor, memory_budget=memory_budget,
                     chunk=chunk, max_retries=max_retries, tracer=tracer)
    ate = out["ate"]
    point = (None if ate_point is None else
             torch.tensor([ate_point], dtype=_F32, device=ate.device))
    return _result({"theta": ate[:, None], "ate": ate}, scheme, name, point,
                   None, alpha, ate_point)


@dataclasses.dataclass(frozen=True)
class MetaResult(EffectResult):
    """A fitted S/T/X learner: the ATE and the pointwise CATE at the
    training rows."""

    ate: float
    cate: Tensor              # (n,) pointwise CATE at the training rows
    learner: str = ""
    cfg: Optional[CausalConfig] = None
    fit_ctx: Optional[Dict[str, Any]] = None
    _inf_cache: Dict[Any, Any] = inf_cache_field()

    estimator_name = "metalearner"

    def _resolve_method(self, method):
        # no fold states to jackknife: the bootstrap stands in for it
        return "bootstrap" if method == "jackknife" else method

    def _replicate_inference(self, method, n_boot, exe, alpha):
        ctx = self.fit_ctx
        return meta_bootstrap(
            ctx["core"], y=ctx["y"], t=ctx["t"], X=ctx["X"],
            seed=derive_seed(ctx["seed"], 0x0b00), alpha=alpha,
            n_replicates=n_boot, scheme=resolve_scheme(method),
            executor=exe, ate_point=self.ate, **self._runtime_kwargs())

    def cate_interval(self, X, alpha=None):
        raise ValueError(
            "metalearner CATEs are not linear in a phi basis; only the "
            "ATE functional carries replicate intervals (ate_interval)")

    def summary(self) -> str:
        """The ATE, and a bootstrap CI only if one was already computed
        (a summary must not start B learner refits)."""
        name = self.learner or self.estimator_name
        lines = [f"{name}_learner result", "-" * 46,
                 f"ATE = {self.ate:+.4f} (n = {self.cate.shape[0]})"]
        cfg = self._config()
        if self._inf_cache:
            res = next(iter(self._inf_cache.values()))
            lo, hi = res.ate_interval(cfg.alpha)
            lines.append(f"bootstrap {100 * (1 - cfg.alpha):.0f}% CI "
                         f"[{lo:+.4f}, {hi:+.4f}]")
        return "\n".join(lines)


def _meta_fit(learner: str, y, t, X, nuisance, propensity, gen, cfg,
              device: DeviceLike, clip: float = 0.01) -> MetaResult:
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    y, t, X = as_f32(y, dev), as_f32(t, dev), as_f32(X, dev)
    core = make_meta_core(learner, cfg, nuisance, propensity, clip)
    ones = torch.ones((X.shape[0],), dtype=_F32, device=dev)
    ate, cate = core(gen, y, t, X, ones)
    ctx = {"core": core, "y": y, "t": t, "X": X, "seed": gen.initial_seed()}
    return MetaResult(ate=float(ate), cate=cate, learner=learner, cfg=cfg,
                      fit_ctx=ctx)


def s_learner(y, t, X, *, nuisance: Optional[Nuisance] = None,
              gen: Optional[torch.Generator] = None,
              cfg: Optional[CausalConfig] = None,
              device: DeviceLike = None) -> MetaResult:
    """One weighted model of E[Y | X, T] over ``[X | t | X·t]``.  Inputs
    move to ``device`` (None: the CUDA card) as fp32; ``gen`` seeds a
    non-linear nuisance's init and, by its initial seed, the bootstrap's
    replicates (default: a CPU generator seeded 0)."""
    return _meta_fit("s", y, t, X, nuisance, None, gen, cfg, device)


def t_learner(y, t, X, *, nuisance: Optional[Nuisance] = None,
              gen: Optional[torch.Generator] = None,
              cfg: Optional[CausalConfig] = None,
              device: DeviceLike = None) -> MetaResult:
    """Per-arm outcome models, τ(x) = m1(x) - m0(x); as ``s_learner``."""
    return _meta_fit("t", y, t, X, nuisance, None, gen, cfg, device)


def x_learner(y, t, X, *, nuisance: Optional[Nuisance] = None,
              propensity: Optional[Nuisance] = None,
              gen: Optional[torch.Generator] = None,
              cfg: Optional[CausalConfig] = None, clip: float = 0.01,
              device: DeviceLike = None) -> MetaResult:
    """Imputed per-arm effects blended by the clipped propensity; as
    ``s_learner``."""
    return _meta_fit("x", y, t, X, nuisance, propensity, gen, cfg, device,
                     clip)
