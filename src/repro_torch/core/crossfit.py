"""Cross-fitting — the paper's §5.1 contribution (C1).

The k out-of-fold nuisance fits run in one of three engines:

  "parallel"      all k fits at once: the fold axis is a batch
                  dimension — weights (k, n), Newton iterates (k, q),
                  ONE fold-batched kernel launch per Gram and batched
                  solves (the translation of the paper's Ray tasks);
  "sequential"    a loop of single-fold fits (the EconML baseline);
  "parallel_loo"  the leave-one-out Gram identity: one fold-segmented
                  pass over X for all k fits (exact for ridge, a fixed
                  majorizer for logistic).

Fold assignment draws from an explicit ``torch.Generator``; parity
tests hand in the reference's fold ids instead.  With a ``tracer``
(``repro_torch.obs.Tracer``) each target's fits run inside a
``crossfit:<nuisance>`` span that closes once the card has finished
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.nuisance import (Nuisance, logistic_fit_folds,
                                       ridge_fit_folds)
from repro_torch.obs.trace import maybe_span

Tensor = torch.Tensor


def fold_ids(gen: torch.Generator, n: int, k: int, device=None) -> Tensor:
    """Balanced random fold assignment in [0, k), drawn on ``gen``'s
    device and moved to ``device``."""
    base = torch.arange(n, device=gen.device) % k
    perm = torch.randperm(n, generator=gen, device=gen.device)
    return base[perm].to(device if device is not None else gen.device)


def fold_weights(folds: Tensor, k: int) -> Tensor:
    """(…, k, n) training weights for (…, n) folds: 1.0 iff the row is
    OUTSIDE fold j."""
    ids = torch.arange(k, device=folds.device, dtype=folds.dtype)
    return (folds[..., None, :] != ids[:, None]).to(torch.float32)


def _oof_select(preds_kn: Tensor, folds: Tensor) -> Tensor:
    """Row i keeps the prediction of model folds[i] — its held-out model.
    (…, k, n) predictions and (…, n) folds -> (…, n)."""
    idx = folds.long().unsqueeze(-2)
    return torch.gather(preds_kn, -2, idx).squeeze(-2)


def _stack_states(states) -> Dict[str, Tensor]:
    return {key: torch.stack([s[key] for s in states]) for key in states[0]}


def crossfit_parallel(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                      target: Tensor, folds: Tensor, k: int
                      ) -> Tuple[Tensor, Any]:
    """All k fold fits as ONE fold-batched fit.  Returns (out-of-fold
    predictions (n,), states with a leading k)."""
    p = X.shape[1]
    state = _stack_states([nuis.init(gen, p, X.device) for _ in range(k)])
    states = nuis.fit(state, X, target, fold_weights(folds, k))
    return _oof_select(nuis.predict(states, X), folds), states


def crossfit_parallel_loo(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                          target: Tensor, folds: Tensor, k: int,
                          mm_iters: int = 32) -> Tuple[Tensor, Any]:
    """One fold-segmented moments pass for all k fits (row-blocked when
    the nuisance carries a ``row_block`` hyper)."""
    hyper = nuis.hyper or {}
    rb, st = hyper.get("row_block", 0), hyper.get("strategy", None)
    if nuis.name == "ridge":
        states = ridge_fit_folds(hyper["lam"], X, target, folds, k,
                                 row_block=rb, strategy=st)
    elif nuis.name == "logistic":
        states = logistic_fit_folds(hyper["lam"], mm_iters, X, target,
                                    folds, k, row_block=rb, strategy=st)
    else:
        return crossfit_parallel(nuis, gen, X, target, folds, k)
    return _oof_select(nuis.predict(states, X), folds), states


def crossfit_sequential(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                        target: Tensor, folds: Tensor, k: int
                        ) -> Tuple[Tensor, Any]:
    """The EconML-style baseline: one fit per fold, strictly in turn."""
    p = X.shape[1]
    W = fold_weights(folds, k)
    states = [nuis.fit(nuis.init(gen, p, X.device), X, target, W[j])
              for j in range(k)]
    preds = torch.stack([nuis.predict(s, X) for s in states])
    return _oof_select(preds, folds), _stack_states(states)


@dataclasses.dataclass(frozen=True)
class CrossfitResult:
    """Out-of-fold nuisance predictions, folds and fold states."""

    oof_y: Tensor      # (n,) out-of-fold E[Y|X]
    oof_t: Tensor      # (n,) out-of-fold E[T|X]
    folds: Tensor      # (n,) fold assignment
    states_y: Any
    states_t: Any


_ENGINES = {"parallel": crossfit_parallel,
            "parallel_loo": crossfit_parallel_loo,
            "sequential": crossfit_sequential}


def crossfit_one(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                 target: Tensor, folds: Tensor, k: int,
                 engine: str = "parallel", tracer=None
                 ) -> Tuple[Tensor, Any]:
    """Engine dispatch for ONE cross-fit target over fixed folds, in a
    ``crossfit:<nuisance>`` span when ``tracer`` is given."""
    fn = _ENGINES.get(engine)
    if fn is None:
        raise NotImplementedError(
            f"engine {engine!r}: executor-mapped engines land with the "
            "runtime slice (ROADMAP A.9); use parallel | sequential | "
            "parallel_loo")
    with maybe_span(tracer, f"crossfit:{nuis.name}", cat="crossfit", k=k,
                    n=int(X.shape[0]), backend=engine):
        out = fn(nuis, gen, X, target, folds, k)
        if tracer is not None:
            tracer.sync(out)
    return out


def crossfit(nuis_y: Nuisance, nuis_t: Nuisance, gen: torch.Generator,
             X: Tensor, y: Tensor, t: Tensor, k: int,
             engine: str = "parallel", tracer=None) -> CrossfitResult:
    """Cross-fit both nuisances over one fold assignment drawn on
    ``gen``."""
    folds = fold_ids(gen, X.shape[0], k, device=X.device)
    oof_y, st_y = crossfit_one(nuis_y, gen, X, y, folds, k, engine, tracer)
    oof_t, st_t = crossfit_one(nuis_t, gen, X, t, folds, k, engine, tracer)
    return CrossfitResult(oof_y=oof_y, oof_t=oof_t, folds=folds,
                          states_y=st_y, states_t=st_t)
