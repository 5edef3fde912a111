"""The segmented DML fast path: all E segments' cross-fit estimates
from ONE segment×fold-segmented pass over the data.

A masked sweep cell re-reads every row per cell — E cells touch E·n
rows.  But each row belongs to exactly one (segment, fold) pair, so one
``moments.fold_gram`` pass over the combined id ``segment·K + fold``
yields every per-(segment, fold) held-out Gram at once, and the
leave-one-out identity

    G_complement[s, j] = (Σ_j' Gh[s, j']) - Gh[s, j]

turns them into all E·K fold-complement normal equations with NO
second data pass.  Ridge nuisances stay EXACT; the logistic treatment
nuisance uses the Böhning-Lindsay fixed majorizer (H0 = Gram/4 + λI,
then ``2·newton_iters`` MM steps), converging to the same optimum as
Newton.  The orthogonal final stage and its HC0 meat are per-segment
Grams over the residuals.

``cfg.row_block_strategy="pallas"`` takes the segment-walking kernel
of ``kernels/seg_gram`` for the fold Grams (S = E·K), the MM gradient
terms and the per-segment final stage: each block reads one segment's
own rows, so neither the (n, E) nor the (n, E·K) one-hot mask
materializes and no launch multiplies its zeros.  Otherwise the
gradient terms and the final stage are one-hot einsums, as in the
reference.  The per-row coefficient gathers (the reference's
``beta[sids]``, an (n, k, q) tensor — 10.5 GB at n = 2^20, k = 5,
q = 501) run over row blocks of ``GATHER_ROWS``, so the gathered
coefficients stay under 0.7 GB.

Inside ``use_data_mesh`` (``launch/sweep_cell.py`` under a mesh) the
fold Grams and the final stage's two Grams pass ``cfg.row_block``: each
block is one launch on the rank that owns it.  The MM loop's gradient
terms stay whole-array on every rank, as the reference's do.  The
sweep engine runs its segmented columns without a mesh.

On row-sharded ``DTensor``s (``launch/sweep_cell.row_sharding``) each
rank reads only its own rows: every segment Gram and gradient term is
its rows' share summed across the mesh (``sharding.row_sum``), the
coefficient gathers run on its rows (``sharding.rowwise``), and the
fold ids drawn here are laid out as the segment ids.

Contract: a *different execution* of the same estimator, not the same
bits — it shares one fold assignment across cells and swaps Newton for
MM, so tests assert tolerance-equality against the reference's sweep on
the same folds.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import CausalConfig
from repro_torch.core import moments
from repro_torch.core.crossfit import fold_ids
from repro_torch.core.final_stage import cate_basis
from repro_torch.distributed.sharding import row_sum, rows_like, rowwise
from repro_torch.inference.numerics import det_inv, det_solve
from repro_torch.kernels.seg_gram import ops as sg_ops

Tensor = torch.Tensor
_F32 = torch.float32

# rows per block of the per-row coefficient gathers
GATHER_ROWS = 65536


def segmented_supported(rspec, cfg: CausalConfig) -> bool:
    """The one-pass kernels cover the linear-nuisance DML family."""
    if cfg.discrete_treatment:
        t_kind_ok = cfg.nuisance_t == "logistic"
    else:
        # continuous T is ridge-fit here; a logistic nuisance_t would
        # silently become a different estimator than cells mode
        t_kind_ok = cfg.nuisance_t == "ridge"
    return (rspec.name.startswith("dml") and cfg.nuisance_y == "ridge"
            and t_kind_ok)


def _aug(X: Tensor) -> Tensor:
    return torch.cat([X, torch.ones_like(X[:, :1])], dim=1)


def _one_hot(ids: Tensor, n: int) -> Tensor:
    return (ids[:, None] == torch.arange(n, device=ids.device)).to(_F32)


def _gathered_dot(Xa: Tensor, coef: Tensor, idx: Tensor) -> Tensor:
    """``<Xa_n, coef[idx_n, ..., :]>`` for every row: (n, ...).  The
    reference gathers ``coef[idx]`` for all rows at once; here it is
    gathered over row blocks of GATHER_ROWS (on row-sharded DTensors,
    each rank over its own rows)."""
    def rows(Xa, idx):
        out = []
        for lo in range(0, Xa.shape[0], GATHER_ROWS):
            c = coef[idx[lo:lo + GATHER_ROWS]]
            out.append(torch.einsum("np,n...p->n...",
                                    Xa[lo:lo + GATHER_ROWS], c))
        return torch.cat(out)

    return rowwise(rows, Xa, idx)


def _segment_fold_ridge(X, target, comb, n_segments, k, lam, row_block,
                        strategy):
    """EXACT per-(segment, fold-complement) ridge via the LOO identity:
    one fold_gram pass over the combined segment×fold id (the target
    rides as an appended design column), then E·K tiny solves."""
    q = X.shape[1] + 1
    Gh, counts = moments.fold_gram(X, comb, n_segments * k, intercept=True,
                                   append=target, row_block=row_block,
                                   strategy=strategy)
    Gh = Gh.reshape(n_segments, k, q + 1, q + 1)
    counts = counts.reshape(n_segments, k)
    A_aug = Gh.sum(dim=1)[:, None] - Gh              # complement Grams
    n_eff = torch.clamp(counts.sum(1, keepdim=True) - counts, min=1.0)
    eye = torch.eye(q, dtype=_F32, device=X.device)
    A = A_aug[..., :q, :q] / n_eff[..., None, None] + lam * eye
    b = A_aug[..., :q, q] / n_eff[..., None]
    return det_solve(A, b), n_eff                     # (E, k, q)


def _segment_fold_logistic(Xa, tt, sids, folds, comb, n_segments, k, lam,
                           iters, row_block, strategy):
    """Per-(segment, fold-complement) logistic via the Böhning-Lindsay
    fixed majorizer: H0 from one segmented Gram pass, then ``iters`` MM
    steps, each reading the data once for its two gradient terms."""
    q = Xa.shape[1]
    GhX, counts = moments.fold_gram(Xa, comb, n_segments * k,
                                    row_block=row_block, strategy=strategy)
    GhX = GhX.reshape(n_segments, k, q, q)
    counts = counts.reshape(n_segments, k)
    n_eff = torch.clamp(counts.sum(1, keepdim=True) - counts, min=1.0)
    eye = torch.eye(q, dtype=_F32, device=Xa.device)
    H0 = (GhX.sum(dim=1)[:, None] - GhX) / (4.0 * n_eff[..., None, None]) \
        + lam * eye
    if strategy == "pallas":
        # held-in sums per segment (t1) and own-fold sums (t2) by the
        # segment walk: no one-hot mask, no multiplied zeros.  These run
        # whole-array (no row_block), as the reference's in-loop calls
        # do; the final stage's pass the config's row_block
        def terms(r, rr, Xa, sids, comb):
            t1 = sg_ops.segment_outer(r, Xa, sids, n_segments)
            t2 = sg_ops.segment_outer(rr, Xa, comb, n_segments * k)
            return t1, t2.reshape(n_segments, k, q)

        def grad_terms(r, rr):
            return row_sum(terms, r, rr, Xa, sids, comb)
    else:
        oh_seg = _one_hot(sids, n_segments)               # (n, E)
        oh_comb = _one_hot(comb, n_segments * k)          # (n, E·k)

        def terms(r, rr, Xa, oh_seg, oh_comb):
            t1 = torch.einsum("ns,nk,np->skp", oh_seg, r, Xa)
            t2 = torch.einsum("nc,n,np->cp", oh_comb, rr, Xa)
            return t1, t2.reshape(n_segments, k, q)

        def grad_terms(r, rr):
            return row_sum(terms, r, rr, Xa, oh_seg, oh_comb)

    beta = torch.zeros((n_segments, k, q), dtype=_F32, device=Xa.device)
    for _ in range(iters):
        mu = torch.sigmoid(_gathered_dot(Xa, beta, sids))     # (n, k)
        r = mu - tt[:, None]
        # held-in sums per segment minus own-fold sums = complement
        rr = torch.gather(r, 1, folds[:, None])[:, 0]
        t1, t2 = grad_terms(r, rr)
        g = (t1 - t2) / n_eff[..., None] + lam * beta
        beta = beta - det_solve(H0, g)
    return beta


def _segment_final_stage(ry, rt, phi, sids, n_segments, ridge=1e-8,
                         row_block=0, strategy=None):
    """Per-segment orthogonal final stage + HC0 sandwich, all E segments
    from segment-Grams over the residuals: the segment walk under
    strategy="pallas", one-hot einsums otherwise."""
    pf = phi.shape[1]
    z = rt[:, None] * phi
    m = torch.cat([z, ry[:, None]], dim=1)
    if strategy == "pallas":
        gaug = row_sum(lambda m, sids: sg_ops.segment_outer(
            m, m, sids, n_segments, row_block=row_block), m, sids)
        nseg = torch.clamp(row_sum(lambda sids: sg_ops.segment_counts(
            sids, n_segments), sids), min=1.0)
    else:
        oh_seg = _one_hot(sids, n_segments)
        gaug = row_sum(lambda oh, m: torch.einsum("ns,ni,nj->sij", oh, m, m),
                       oh_seg, m)
        nseg = torch.clamp(row_sum(lambda oh: oh.sum(0), oh_seg), min=1.0)
    eye = torch.eye(pf, dtype=_F32, device=phi.device)
    a = gaug[:, :pf, :pf] + ridge * nseg[:, None, None] * eye
    theta = det_solve(a, gaug[:, :pf, pf])
    e = ry - (z * rowwise(lambda s: theta[s], sids)).sum(dim=1)
    me = e[:, None] * z
    if strategy == "pallas":
        meat = row_sum(lambda me, sids: sg_ops.segment_outer(
            me, me, sids, n_segments, row_block=row_block), me, sids)
    else:
        meat = row_sum(lambda oh, me: torch.einsum(
            "ns,ni,nj->sij", oh, me, me), oh_seg, me)
    ainv = det_inv(a)
    cov = torch.einsum("sia,sab,sbj->sij", ainv, meat, ainv)
    se = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0))
    return theta, se


def segmented_dml_sweep(cfg: CausalConfig, X: Tensor, y: Tensor, t: Tensor,
                        sids: Tensor, n_segments: int,
                        gen: torch.Generator) -> Dict[str, Tensor]:
    """All E per-segment DML fits from one segmented pass: shared fold
    assignment (drawn on ``gen``), LOO-identity ridge + MM logistic
    nuisances, per-segment final stage.  Returns {"theta" (E, p),
    "se" (E, p), "ate" (E,)}."""
    n, dev = X.shape[0], X.device
    k, lam = cfg.n_folds, cfg.ridge_lambda
    rb, st = cfg.row_block, cfg.row_block_strategy
    sids = sids.long()
    folds = rows_like(fold_ids(gen, n, k, device=dev).long(), sids)
    comb = sids * k + folds                           # (n,) in [0, E·k)

    beta_y, _ = _segment_fold_ridge(X, y, comb, n_segments, k, lam, rb, st)
    xa = _aug(X.to(_F32))
    tt = t.to(_F32)
    mm_iters = 2 * cfg.newton_iters  # MM trades per-step cost for steps
    if cfg.discrete_treatment:
        beta_t = _segment_fold_logistic(xa, tt, sids, folds, comb,
                                        n_segments, k, lam, mm_iters, rb, st)
        mt = torch.sigmoid(_gathered_dot(
            xa, beta_t.reshape(n_segments * k, -1), comb))
    else:
        beta_t, _ = _segment_fold_ridge(X, t, comb, n_segments, k, lam, rb,
                                        st)
        mt = _gathered_dot(xa, beta_t.reshape(n_segments * k, -1), comb)

    # out-of-fold predictions: each row read once by its own
    # (segment, fold) model — a gather, not an (E, n) prediction matrix
    my = _gathered_dot(xa, beta_y.reshape(n_segments * k, -1), comb)
    ry = y.to(_F32) - my
    rt = tt - mt
    phi = cate_basis(X, cfg.cate_features)
    theta, se = _segment_final_stage(ry, rt, phi, sids, n_segments,
                                     row_block=rb, strategy=st)
    return {"theta": theta, "se": se, "ate": theta[:, 0]}


def segmented_column(cfg: CausalConfig, base_data: Dict[str, Any],
                     n_segments: int, gen: torch.Generator
                     ) -> Dict[str, Tensor]:
    """Engine adapter: the segmented sweep over the engine's base data."""
    return segmented_dml_sweep(cfg, base_data["X"], base_data["y"],
                               base_data["t"], base_data["sids"], n_segments,
                               gen)
