"""Cross-fitting — the paper's §5.1 contribution (C1).

The k out-of-fold nuisance fits map their fold axis (the fold-
complement weights and the init states) through the task runtime
(``repro_torch.runtime``), the one "how iterative steps run" knob the
bootstrap's replicates share:

  "parallel"      the ``vmap`` executor: all k fits at once, the fold
                  axis a batch dimension — weights (k, n), Newton
                  iterates (k, q), ONE fold-batched kernel launch per
                  Gram and batched solves (the translation of the
                  paper's Ray tasks);
  "sequential"    the ``serial`` executor: one fold fit after another
                  (the EconML baseline);
  "parallel_loo"  the leave-one-out Gram identity: one fold-segmented
                  pass over X for all k fits (exact for ridge, a fixed
                  majorizer for logistic) — no map;
  any other executor name, Executor or TaskRuntime maps the fold axis
  directly (a TaskRuntime brings its budget, ladder and tracer).

Fold assignment draws from an explicit ``torch.Generator``; parity
tests hand in the reference's fold ids instead.  With a tracer (the
``tracer`` argument, or the TaskRuntime's own) each target's fits run
inside a ``crossfit:<nuisance>`` span that closes once the card has
finished them, the runtime's map and chunk spans nested inside.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.nuisance import (Nuisance, logistic_fit_folds,
                                       ridge_fit_folds)
from repro_torch.distributed.sharding import per_shard
from repro_torch.obs.trace import maybe_span
from repro_torch.pytree import tree_map

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
    return per_shard(lambda f: (f[..., None, :] != ids[:, None]).to(
        torch.float32), folds)


def _oof_select(preds_kn: Tensor, folds: Tensor) -> Tensor:
    """Row i keeps the prediction of model folds[i] — its held-out model.
    (…, k, n) predictions and (…, n) folds -> (…, n)."""
    return per_shard(lambda p, f: torch.gather(
        p, -2, f.long().unsqueeze(-2)).squeeze(-2), preds_kn, folds)


def _stack_states(states) -> Dict[str, Any]:
    """Per-fold init states (trees of tensors) -> one state with a
    leading fold axis."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


@functools.lru_cache(maxsize=128)
def _fold_fit_fn(nuis: Nuisance):
    """The fold-fit function the runtime maps: the fits of a chunk of
    folds (init states and complement weights with a leading fold axis)
    as one fold-batched fit.  Cached per Nuisance, so repeated cross-fits
    hand the runtime the same closure (its memory model is cached on
    it)."""

    def fold_fit(xs, X, target):
        st = nuis.fit(xs["state"], X, target, xs["w"])
        return nuis.predict(st, X), st

    return fold_fit


def _crossfit_engine(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                     target: Tensor, folds: Tensor, k: int, executor,
                     tracer=None, backend: str = ""
                     ) -> Tuple[Tensor, Any]:
    """The fold axis (init states + fold-complement weights) mapped
    through the task runtime, in a ``crossfit:<nuisance>`` span when the
    runtime traces.  Returns (out-of-fold predictions (n,), states with
    a leading k)."""
    from repro_torch.runtime import as_runtime
    rt = as_runtime(executor, tracer=tracer)
    p = X.shape[1]
    state = _stack_states([nuis.init(gen, p, X.device) for _ in range(k)])
    label = f"crossfit:{nuis.name}"
    with maybe_span(rt.tracer, label, cat="crossfit", k=k,
                    n=int(X.shape[0]), backend=backend or rt.name):
        preds, states = rt.map(_fold_fit_fn(nuis),
                               {"state": state, "w": fold_weights(folds, k)},
                               X, target, label=label)
        if rt.tracer is not None:
            rt.tracer.sync((preds, states))
    return _oof_select(preds, folds), states


def crossfit_parallel(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                      target: Tensor, folds: Tensor, k: int, tracer=None
                      ) -> Tuple[Tensor, Any]:
    """All k fold fits as ONE fold-batched fit (the fold axis through
    the ``vmap`` executor).  Returns (out-of-fold predictions (n,),
    states with a leading k)."""
    return _crossfit_engine(nuis, gen, X, target, folds, k, "vmap",
                            tracer, "parallel")


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
                        target: Tensor, folds: Tensor, k: int, tracer=None
                        ) -> Tuple[Tensor, Any]:
    """The EconML-style baseline: one fit per fold, strictly in turn —
    the fold axis through the ``serial`` executor, no loop of its own."""
    return _crossfit_engine(nuis, gen, X, target, folds, k, "serial",
                            tracer, "sequential")


@dataclasses.dataclass(frozen=True)
class CrossfitResult:
    """Out-of-fold nuisance predictions, folds and fold states."""

    oof_y: Tensor      # (n,) out-of-fold E[Y|X]
    oof_t: Tensor      # (n,) out-of-fold E[T|X]
    folds: Tensor      # (n,) fold assignment
    states_y: Any
    states_t: Any


def crossfit_one(nuis: Nuisance, gen: torch.Generator, X: Tensor,
                 target: Tensor, folds: Tensor, k: int,
                 engine="parallel", tracer=None) -> Tuple[Tensor, Any]:
    """Engine dispatch for ONE cross-fit target over fixed folds:
    "parallel" maps the fold axis through ``vmap``, "sequential" through
    ``serial``, "parallel_loo" takes the one-pass LOO-Gram path; any
    other executor name, Executor or TaskRuntime maps the fold axis
    directly.  In a ``crossfit:<nuisance>`` span when tracing."""
    if engine == "parallel_loo":
        with maybe_span(tracer, f"crossfit:{nuis.name}", cat="crossfit",
                        k=k, n=int(X.shape[0]), backend=engine):
            out = crossfit_parallel_loo(nuis, gen, X, target, folds, k)
            if tracer is not None:
                tracer.sync(out)
        return out
    if engine == "sequential":
        return crossfit_sequential(nuis, gen, X, target, folds, k, tracer)
    if engine == "parallel":
        return crossfit_parallel(nuis, gen, X, target, folds, k, tracer)
    return _crossfit_engine(nuis, gen, X, target, folds, k, engine, tracer)


def crossfit(nuis_y: Nuisance, nuis_t: Nuisance, gen: torch.Generator,
             X: Tensor, y: Tensor, t: Tensor, k: int,
             engine="parallel", tracer=None) -> CrossfitResult:
    """Cross-fit both nuisances over one fold assignment drawn on
    ``gen``; ``engine`` as ``crossfit_one``."""
    folds = fold_ids(gen, X.shape[0], k, device=X.device)
    oof_y, st_y = crossfit_one(nuis_y, gen, X, y, folds, k, engine, tracer)
    oof_t, st_t = crossfit_one(nuis_t, gen, X, t, folds, k, engine, tracer)
    return CrossfitResult(oof_y=oof_y, oof_t=oof_t, folds=folds,
                          states_y=st_y, states_t=st_t)
