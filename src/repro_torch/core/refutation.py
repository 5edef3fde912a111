"""Refutation tests — the dowhy-style robustness checks of the paper's
validation suite (§4), re-run through the task runtime:

  placebo_treatment      permuted T  -> estimate should collapse to ~0
  random_common_cause    X + noise covariate -> estimate should be stable
  data_subset            random half of rows -> estimate should be stable
  placebo_instrument     permuted Z (OrthoIV) -> ~0
  weak_instrument        first-stage F screen of an IV fit

Each refuter is R independent refits — the concurrency class the paper
parallelizes — dispatched as ONE runtime map over replicate ids
(``repro_torch.runtime``), the same scheduler the bootstrap's replicates
take: chunked, fault-tolerant, bitwise the same on ``executor="serial"``.
Replicate r draws its permutation, noise column or subset mask, and then
its folds, from its own CPU generator (``replicate_generator(seed, r)``,
the lineage of the bootstrap's ``replicate_draws``), so any replicate
replays alone; ``refute_draws`` is that draw, at module level so the
parity tests can hand in the reference's draws instead.

How the refits batch on the card: a permuted treatment or instrument
enters the logistic nuisance through its weights, so placebo refits and
data-subset refits share the design and run as ONE fold-and-replicate
batched fit (a fold_weighted Gram of R·k weight rows); a noise column
changes the design itself, so ``random_common_cause`` fits its
replicates one after another inside the map (each one fold-batched, at
q = p + 3).

``data_subset`` keeps rows in place and zeroes their training and moment
weights, which is estimation-equivalent to dropping them and keeps every
replicate the same shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.crossfit import fold_ids
from repro_torch.core.dml import DML
from repro_torch.core.final_stage import cate_basis
from repro_torch.device import as_f32
from repro_torch.inference.bootstrap import (dml_theta_once, iv_theta_once,
                                             replicate_generator)
from repro_torch.runtime import as_runtime

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RefutationReport:
    """One refuter's replicate ATEs against the original estimate."""

    name: str
    original_ate: float
    refuted_ates: Tuple[float, ...]
    expectation: str  # "zero" | "stable"

    @property
    def mean(self) -> float:
        return float(torch.tensor(self.refuted_ates, dtype=_F32).mean())

    @property
    def passed(self) -> bool:
        m = torch.tensor(self.refuted_ates, dtype=_F32)
        if self.expectation == "zero":
            # placebo effects should be ~0 relative to the real effect
            # (population std, as the reference's jnp.std)
            return bool(m.mean().abs() < 0.25 * abs(self.original_ate)
                        + 3 * m.std(correction=0) + 1e-6)
        rel = (m.mean() - self.original_ate).abs() / max(
            abs(self.original_ate), 1e-9)
        return bool(rel < 0.25)

    def row(self) -> str:
        return (f"{self.name:>22}: original={self.original_ate:+.4f} "
                f"refuted_mean={self.mean:+.4f} "
                f"[{'PASS' if self.passed else 'FAIL'}]")


def refute_draws(kind: str, seed: int, ids: Tensor, n: int, n_folds: int,
                 *, frac: float = 0.5, device=None) -> Dict[str, Tensor]:
    """The draws of replicates ``ids``, each from its own generator:
    first its perturbation — ``"permute"``: a permutation of the rows
    (R, n) int64; ``"noise"``: a standard normal column (R, n) fp32;
    ``"subset"``: a 0/1 weight keeping ``int(n·frac)`` rows (R, n) fp32
    — then its folds (R, n).  Returns {"draw", "folds"} on ``device``."""
    m = int(n * frac)
    draws, folds = [], []
    for b in ids.tolist():
        g = replicate_generator(seed, b)
        if kind == "permute":
            draws.append(torch.randperm(n, generator=g))
        elif kind == "noise":
            draws.append(torch.randn(n, generator=g))
        elif kind == "subset":
            draws.append((torch.randperm(n, generator=g) < m).to(_F32))
        else:
            raise ValueError(f"unknown refutation draw {kind!r}")
        folds.append(fold_ids(g, n, n_folds))
    return {"draw": torch.stack(draws).to(device),
            "folds": torch.stack(folds).to(device)}


def _run_replicates(fn, n_reps: int, executor, *arrays,
                    label: str = "refute") -> Tuple[float, ...]:
    """Map ``n_reps`` refits through the task runtime and extract the
    leading (ATE) coefficient of each."""
    rt = as_runtime(executor)
    thetas = rt.map(fn, torch.arange(n_reps), *arrays, label=label)["theta"]
    return tuple(float(a) for a in thetas[:, 0])


def _inputs(est, *arrays):
    return tuple(as_f32(a, est.device) for a in arrays)


def _fit_kw(cfg: CausalConfig) -> dict:
    return dict(with_se=False, row_block=cfg.row_block,
                strategy=cfg.row_block_strategy)


def placebo_treatment(est: DML, y, t, X, *, original_ate: float,
                      n_reps: int = 3, seed: int = 7,
                      executor="vmap") -> RefutationReport:
    """Permute T: the refits' ATEs should collapse to ~0."""
    y, t, X = _inputs(est, y, t, X)
    cfg = est.cfg
    phi = cate_basis(X, cfg.cate_features)

    def refit(ids, y_, t_, X_, phi_):
        d = refute_draws("permute", seed, ids, X_.shape[0], cfg.n_folds,
                         device=X_.device)
        t_fake = t_[d["draw"]]                                  # (R, n)
        return dml_theta_once(est.nuis_y, est.nuis_t, cfg.n_folds, X_, y_,
                              t_fake, phi_, d["folds"],
                              torch.ones_like(t_fake), **_fit_kw(cfg))

    ates = _run_replicates(refit, n_reps, executor, y, t, X, phi,
                           label="placebo_treatment")
    return RefutationReport("placebo_treatment", original_ate, ates, "zero")


def random_common_cause(est: DML, y, t, X, *, original_ate: float,
                        n_reps: int = 3, seed: int = 8,
                        executor="vmap") -> RefutationReport:
    """Append a random covariate: the ATE should stay put."""
    y, t, X = _inputs(est, y, t, X)
    cfg = est.cfg
    phi = cate_basis(X, cfg.cate_features)

    def refit(ids, y_, t_, X_, phi_):
        d = refute_draws("noise", seed, ids, X_.shape[0], cfg.n_folds,
                         device=X_.device)
        ones = torch.ones_like(y_)
        # another design per replicate: one fold-batched fit each
        thetas = [dml_theta_once(
            est.nuis_y, est.nuis_t, cfg.n_folds,
            torch.cat([X_, d["draw"][r][:, None]], dim=1), y_, t_, phi_,
            d["folds"][r], ones, **_fit_kw(cfg))["theta"]
            for r in range(len(ids))]
        return {"theta": torch.stack(thetas)}

    ates = _run_replicates(refit, n_reps, executor, y, t, X, phi,
                           label="random_common_cause")
    return RefutationReport("random_common_cause", original_ate, ates,
                            "stable")


def data_subset(est: DML, y, t, X, *, original_ate: float,
                frac: float = 0.5, n_reps: int = 3, seed: int = 9,
                executor="vmap") -> RefutationReport:
    """Refit on a random ``frac`` of the rows: the ATE should stay put."""
    y, t, X = _inputs(est, y, t, X)
    cfg = est.cfg
    phi = cate_basis(X, cfg.cate_features)

    def refit(ids, y_, t_, X_, phi_):
        # weight out (1 - frac) of the rows instead of slicing them away:
        # the same moments, one shape for every replicate
        d = refute_draws("subset", seed, ids, X_.shape[0], cfg.n_folds,
                         frac=frac, device=X_.device)
        return dml_theta_once(est.nuis_y, est.nuis_t, cfg.n_folds, X_, y_,
                              t_, phi_, d["folds"], d["draw"],
                              **_fit_kw(cfg))

    ates = _run_replicates(refit, n_reps, executor, y, t, X, phi,
                           label="data_subset")
    return RefutationReport("data_subset", original_ate, ates, "stable")


# ---------------------------------------------------------------------------
# Instrument-side refuters (repro_torch.core.iv).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeakInstrumentReport:
    """First-stage F screen (Stock-Yogo rule of thumb: F < 10 ⇒ weak
    instrument ⇒ 2SLS point estimates and CIs are unreliable)."""

    f_stat: float
    threshold: float
    instrument_corr: float

    @property
    def passed(self) -> bool:
        return self.f_stat >= self.threshold

    def row(self) -> str:
        return (f"{'weak_instrument':>22}: F={self.f_stat:.1f} "
                f"(threshold {self.threshold:.0f}) corr(rz,rt)="
                f"{self.instrument_corr:+.3f} "
                f"[{'PASS' if self.passed else 'FAIL'}]")


def weak_instrument(res, *, threshold: float = 10.0) -> WeakInstrumentReport:
    """Screen a fitted OrthoIV / DRIV result's first stage: the robust F
    of ``rt ~ rz`` recomputed from the result's out-of-fold residuals
    (``estimands.first_stage_f``), or the fit's own diagnostics where
    the result keeps no cross-fit (DRIV)."""
    from repro_torch.core.estimands import first_stage_f
    cf = res.fit_ctx
    if cf is None or not hasattr(res, "crossfit"):
        d = res.diagnostics
        return WeakInstrumentReport(f_stat=d.first_stage_f,
                                    threshold=threshold,
                                    instrument_corr=d.instrument_corr)
    rt_res = (cf.t - res.crossfit.oof_t).to(_F32)
    rz_res = (cf.z - res.crossfit.oof_z).to(_F32)
    corr = float(torch.corrcoef(torch.stack([rz_res, rt_res]))[0, 1])
    return WeakInstrumentReport(f_stat=first_stage_f(rt_res, rz_res),
                                threshold=threshold, instrument_corr=corr)


def placebo_instrument(est, y, t, z, X, *, original_ate: float,
                       n_reps: int = 3, seed: int = 17,
                       executor="vmap") -> RefutationReport:
    """Permute Z: a scrambled instrument carries no first-stage signal,
    so the refits' estimates should scatter around zero.  Each replicate
    is one weighted OrthoIV refit; the permuted instruments ride in one
    fold-and-replicate batched fit of the instrument nuisance."""
    y, t, z, X = _inputs(est, y, t, z, X)
    cfg = est.cfg
    phi = cate_basis(X, cfg.cate_features)

    def refit(ids, y_, t_, z_, X_, phi_):
        d = refute_draws("permute", seed, ids, X_.shape[0], cfg.n_folds,
                         device=X_.device)
        z_fake = z_[d["draw"]]                                  # (R, n)
        return iv_theta_once(est.nuis_y, est.nuis_t, est.nuis_z,
                             cfg.n_folds, X_, y_, t_, z_fake, phi_,
                             d["folds"], torch.ones_like(z_fake),
                             **_fit_kw(cfg))

    ates = _run_replicates(refit, n_reps, executor, y, t, z, X, phi,
                           label="placebo_instrument")
    return RefutationReport("placebo_instrument", original_ate, ates,
                            "zero")


def run_all(cfg: CausalConfig, y, t, X, *, seed: int = 0, executor="vmap",
            device=None, tracer=None) -> Tuple[RefutationReport, ...]:
    """The refuter panel on ONE shared task runtime (configured from
    ``cfg.runtime_*``): a DML fit (folds from a CPU generator seeded
    ``seed``), then the three refuters as independent ``call`` nodes of
    a task graph gathered together, each branch's replicate map going
    through the same chunked, fault-tolerant scheduler.  ``device``:
    where it runs (None: the CUDA card); ``tracer``: the runtime's."""
    est = DML(cfg, device=device)
    y, t, X = _inputs(est, y, t, X)
    a0 = est.fit(y, t, X, gen=torch.Generator().manual_seed(seed)).ate
    rt = as_runtime(executor, memory_budget=cfg.runtime_memory_budget,
                    chunk=cfg.runtime_chunk,
                    max_retries=cfg.runtime_max_retries, tracer=tracer)
    p = rt.call(lambda: placebo_treatment(
        est, y, t, X, original_ate=a0, seed=seed, executor=rt),
        label="placebo_treatment")
    r = rt.call(lambda: random_common_cause(
        est, y, t, X, original_ate=a0, seed=seed, executor=rt),
        label="random_common_cause")
    d = rt.call(lambda: data_subset(
        est, y, t, X, original_ate=a0, seed=seed, executor=rt),
        label="data_subset")
    return tuple(rt.gather([p, r, d]))
