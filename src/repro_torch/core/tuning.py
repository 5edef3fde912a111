"""Hyper-parameter tuning — the paper's §5.2 contribution (C2) — on the
card.

Ray Tune's trial pool becomes a batch axis: trials differ only in scalar
hyper-parameters, so the whole (trial × fold) grid of a penalty search
is ONE ``TaskRuntime.map_product`` whose cell is batch-aware — a chunk
of (λ, fold id) cells is one batched ridge or logistic fit, every
weighted Gram of it one launch of the segment-Gram kernel under
``strategy="pallas"`` on the card.  ``successive_halving`` (ASHA-style
rungs over the mlp's learning rate) is a dependent task graph on the
runtime's futures: rung r's map scores the survivors, a host ``call``
keeps the best 1/eta, and rung r+1's map consumes that future.

Scores are out-of-fold losses: MSE for regression, log-loss for
classification.

Differences from the reference: the penalty grid's fits take the
``row_block`` and ``strategy`` they are given (``tuned_nuisances`` passes
the config's), where the reference's grid runs the whole-array forms;
folds are drawn on a ``torch.Generator`` (parity tests hand in the
reference's).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.crossfit import _oof_select, fold_ids, fold_weights
from repro_torch.core.nuisance import (Nuisance, make_logistic, make_mlp,
                                       make_ridge)
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.runtime import TaskFuture, as_runtime

Tensor = torch.Tensor
_F32 = torch.float32


def _losses(pred: Tensor, target: Tensor, task: str) -> Tensor:
    """Per-row loss: log-loss on clipped probabilities, or squared error."""
    yt = target.to(_F32)
    if task == "clf":
        p = torch.clamp(pred, 1e-6, 1 - 1e-6)
        return -(yt * torch.log(p) + (1 - yt) * torch.log(1 - p))
    return torch.square(pred - yt)


def _oof_score(preds_kn: Tensor, folds: Tensor, target: Tensor,
               task: str) -> Tensor:
    """Mean out-of-fold loss of (k, n) fold-model predictions."""
    return _losses(_oof_select(preds_kn, folds), target, task).mean()


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """A penalty grid's winner and every trial's out-of-fold score."""

    best_index: int
    best_value: float
    best_score: float
    scores: Tensor        # (T,) per-trial out-of-fold scores
    values: Tensor        # (T,) the swept hyper-parameter values


# ---------------------------------------------------------------------------
# Grid search over penalty strength (ridge / logistic): one map_product
# over the (trial × fold) grid.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _penalty_cell_fn(task: str, newton_iters: int, row_block: int,
                     strategy: Optional[str]):
    """The (trial, fold) cell of the grid, batch-aware: lam (c,) and fold
    ids j (c,) -> the c cells' summed held-out losses (c,), one batched
    fit under the weight rows ``W[j]``.  The output is (T, K) summed
    losses, never a (T, K, n) tensor.  Cached, so repeated tune calls
    hand the runtime the same closure."""
    proto = (make_logistic(1.0, newton_iters, row_block=row_block,
                           strategy=strategy) if task == "clf"
             else make_ridge(1.0, row_block=row_block, strategy=strategy))

    def cell(lam, j, X, target, W, folds, st0):
        st = proto.fit({**st0, "lam": lam}, X, target, W[j])
        loss = _losses(proto.predict(st, X), target, task)       # (c, n)
        mask = (folds[None, :] == j[:, None]).to(_F32)   # held-out rows
        return torch.stack([(mask[i] * loss[i]).sum()
                            for i in range(loss.shape[0])])

    return proto, cell


def tune_penalty(task: str, lams, X, target, *, n_folds: int = 5,
                 gen: Optional[torch.Generator] = None,
                 newton_iters: int = 16, executor="vmap",
                 row_block: int = 0, strategy: Optional[str] = None,
                 device: DeviceLike = None) -> TuneResult:
    """Cross-validated penalty grid for ridge ("reg") or logistic
    ("clf"): the (T trials × n_folds) cells as one ``map_product`` of
    the task runtime over (λ, fold id), the fold weights one
    pass-through tensor indexed by fold id.  Folds are drawn on ``gen``
    (default: a CPU generator seeded 0); inputs move to ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    X, target, lams = as_f32(X, dev), as_f32(target, dev), as_f32(lams, dev)
    folds = fold_ids(gen, X.shape[0], n_folds, device=dev)
    W = fold_weights(folds, n_folds)
    proto, cell = _penalty_cell_fn(task, newton_iters, row_block, strategy)
    rt = as_runtime(executor)
    st0 = proto.init(gen, X.shape[1], dev)       # lam-independent
    cells = rt.map_product(cell, lams, torch.arange(n_folds, device=dev), X,
                           target, W, folds, st0, label="tune_penalty")
    scores = cells.sum(dim=1) / X.shape[0]                        # (T,)
    best = int(torch.argmin(scores))
    return TuneResult(best_index=best, best_value=float(lams[best]),
                      best_score=float(scores[best]), scores=scores,
                      values=lams)


# ---------------------------------------------------------------------------
# Successive halving (ASHA-style) for the mlp nuisance: rung r trains the
# survivors for base_steps * eta^r steps.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HalvingResult:
    """The surviving learning rate and each rung's survivor set and
    scores."""

    best_lr: float
    history: Tuple[Dict, ...]


@functools.lru_cache(maxsize=None)
def _halving_trial_fn(task: str, hidden: Tuple[int, ...], steps: int):
    """The trial function of one rung, batch-aware: lrs (c,) -> the c
    trials' out-of-fold scores, the c × K fold models trained in one
    batched fit from the shared init, lr entering as a state leaf."""
    nz = make_mlp(task, hidden=hidden, steps=steps)

    def trial(lr, X, target, W, folds, st0):
        c, (k, n) = lr.shape[0], W.shape
        st = nz.fit({**st0, "lr": lr[:, None].expand(c, k)}, X, target,
                    W[None].expand(c, k, n))
        preds = nz.predict(st, X)                                # (c, k, n)
        return torch.stack([_oof_score(preds[i], folds, target, task)
                            for i in range(c)])

    return trial


def successive_halving(task: str, lrs, X, target, *, n_folds: int = 3,
                       base_steps: int = 25, eta: int = 2, rungs: int = 3,
                       hidden: Tuple[int, ...] = (64,),
                       gen: Optional[torch.Generator] = None,
                       executor="vmap",
                       device: DeviceLike = None) -> HalvingResult:
    """ASHA-style rungs as a dependent task graph: every rung's map task
    and select call is submitted up front (the survivor counts are
    fixed), and one ``gather`` runs the graph in order.  Ties keep the
    earlier trial (a stable sort)."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    X, target, lrs = as_f32(X, dev), as_f32(target, dev), as_f32(lrs, dev)
    folds = fold_ids(gen, X.shape[0], n_folds, device=dev)
    W = fold_weights(folds, n_folds)
    history: list = []
    steps = base_steps
    rt = as_runtime(executor)
    # init is lr-independent: one state serves every trial and rung
    st0 = make_mlp(task, hidden=hidden, steps=base_steps).init(
        gen, X.shape[1], dev)

    def _select(rung: int, steps_: int, keep: int):
        def select(cur, scores):
            order = torch.argsort(scores, stable=True)
            history.append({"rung": rung, "steps": steps_,
                            "lrs": cur.tolist(),
                            "scores": [float(s) for s in scores],
                            "kept": [float(cur[i]) for i in order[:keep]]})
            return cur[order[:keep]]
        return select

    cur: Any = lrs                      # a tensor, then futures
    n_live = int(lrs.shape[0])
    for rung in range(rungs):
        trial = _halving_trial_fn(task, tuple(hidden), steps)
        scores = rt.submit(trial, cur, X, target, W, folds, st0,
                           label=f"halving_rung{rung}")
        keep = max(1, n_live // eta)
        cur = rt.call(_select(rung, steps, keep), cur, scores,
                      label=f"halving_select{rung}")
        n_live = keep
        steps *= eta
        if n_live == 1:
            break
    final = rt.gather(cur) if isinstance(cur, TaskFuture) else cur
    return HalvingResult(best_lr=float(final[0]), history=tuple(history))


# ---------------------------------------------------------------------------
# Tuned nuisances for the estimators.
# ---------------------------------------------------------------------------

_LAMS = (1e-4, 1e-3, 1e-2, 1e-1)


def _tuned_winner(cfg: CausalConfig, task: str, res: TuneResult
                  ) -> Nuisance:
    """The winning nuisance, with the config's row_block and strategy."""
    if task == "clf":
        return make_logistic(res.best_value, cfg.newton_iters,
                             row_block=cfg.row_block,
                             strategy=cfg.row_block_strategy)
    return make_ridge(res.best_value, row_block=cfg.row_block,
                      strategy=cfg.row_block_strategy)


def _tune(cfg: CausalConfig, task: str, X, target, gen, executor, dev
          ) -> Nuisance:
    res = tune_penalty(task, _LAMS, X, target, n_folds=cfg.n_folds, gen=gen,
                       newton_iters=cfg.newton_iters, executor=executor,
                       row_block=cfg.row_block,
                       strategy=cfg.row_block_strategy, device=dev)
    return _tuned_winner(cfg, task, res)


def tuned_nuisances(cfg: CausalConfig, X, y, t,
                    gen: Optional[torch.Generator] = None, executor="vmap",
                    device: DeviceLike = None) -> Tuple[Nuisance, Nuisance]:
    """Grid-tune both penalty nuisances (λ in 1e-4 .. 1e-1) and return
    the winners — what the paper's §5.2 listing does with its grid
    searches.  Each grid draws its folds from ``gen`` in turn."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    t_task = "clf" if cfg.discrete_treatment else "reg"
    return (_tune(cfg, "reg", X, y, gen, executor, dev),
            _tune(cfg, t_task, X, t, gen, executor, dev))


def tuned_iv_nuisances(cfg: CausalConfig, X, y, t, z,
                       gen: Optional[torch.Generator] = None,
                       executor="vmap", device: DeviceLike = None
                       ) -> Tuple[Nuisance, Nuisance, Nuisance]:
    """Grid-tune the orthogonal-IV triple (E[Y|X], E[T|X], E[Z|X]): three
    ``map_product`` grids."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    t_task = "clf" if cfg.discrete_treatment else "reg"
    z_task = "clf" if cfg.discrete_instrument else "reg"
    return (_tune(cfg, "reg", X, y, gen, executor, dev),
            _tune(cfg, t_task, X, t, gen, executor, dev),
            _tune(cfg, z_task, X, z, gen, executor, dev))
