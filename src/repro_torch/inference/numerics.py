"""Deterministic small solves and the fold-and-replicate batched
weighted fits of replicate inference.

Gauss-Jordan elimination without pivoting, written as broadcast rank-1
updates over any leading batch dimensions: the k delete-fold solves of
the jackknife, and the R·k fold fits of a bootstrap chunk, run as one
batched call, and each system's arithmetic is the same whether it is
solved alone or in a batch.  Every system solved here is SPD plus an
explicit ridge (or, for the instrumented moment, has pivots bounded
away from zero by a relevant instrument), so no pivoting is needed.

The weighted fits take a fold-and-replicate weight batch ``Wk`` of
shape (…, k, n): fold-complement masks times per-row bootstrap weights.
Their Grams are the moments engine's ``fold_weighted_gram`` (one kernel
launch for the whole batch under ``strategy="pallas"``), their
predictions one matrix-vector product per fold and replicate — so a
replicate's arithmetic is the same alone and in a batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import moments

Tensor = torch.Tensor
_F32 = torch.float32


def _gauss_jordan(M: Tensor, p: int) -> Tensor:
    M = M.clone()
    for i in range(p):
        piv = M[..., i, :] / M[..., i, i:i + 1]
        factors = M[..., :, i].clone()
        factors[..., i] = 0.0
        M = M - factors[..., :, None] * piv[..., None, :]
        M[..., i, :] = piv
    return M


def det_solve(A: Tensor, b: Tensor) -> Tensor:
    """(..., p, p) @ x = (..., p) by Gauss-Jordan without pivoting."""
    p = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)
    return _gauss_jordan(M, p)[..., :, -1]


def det_inv(A: Tensor) -> Tensor:
    """Gauss-Jordan inverse of (..., p, p)."""
    p = A.shape[-1]
    eye = torch.eye(p, dtype=A.dtype, device=A.device).expand_as(A)
    return _gauss_jordan(torch.cat([A, eye], dim=-1), p)[..., :, p:]


def _small_mm(A: Tensor, B: Tensor) -> Tensor:
    """(..., p, p) @ (..., p, p) as a broadcast sum over the tiny inner
    axis — elementwise, so independent of the batch."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _aug(X: Tensor) -> Tensor:
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                    device=X.device)], dim=1)


def _predict(beta: Tensor, Xa: Tensor, logistic: bool = False) -> Tensor:
    """(…, q) coefficients over the augmented (n, q) design -> (…, n)
    linear predictions or probabilities, one row at a time: a mat-vec
    on a fresh copy of the coefficient row (a BLAS mat-vec may take
    another path for a vector at another alignment), then the sigmoid on
    that (n,) row (the CPU's vectorized sigmoid rounds some elements
    differently when a longer tensor is split among threads) — so a
    row's numbers do not depend on the batch it sits in."""
    flat = beta.reshape(-1, beta.shape[-1])
    rows = [Xa @ b.clone() for b in flat]
    if logistic:
        rows = [torch.sigmoid(r) for r in rows]
    return torch.stack(rows).reshape(beta.shape[:-1] + (Xa.shape[0],))


# ---------------------------------------------------------------------------
# Fold-and-replicate batched weighted nuisance fits.
# ---------------------------------------------------------------------------

def ridge_fit_folds_w(lam: float, X: Tensor, y: Tensor, Wk: Tensor, *,
                      row_block: int = 0, strategy: Optional[str] = None
                      ) -> Tensor:
    """Weighted ridge for every (…, k) weight row of ``Wk``: one
    augmented ``[X | 1 | y]`` Gram for the whole batch and a batched
    solve.  Returns beta (…, k, p+1), intercept last.  A target with a
    leading replicate axis, y (R, n) beside Wk (R, k, n), is another
    design per replicate: one such fit per replicate, stacked."""
    if y.dim() == 2:
        return torch.stack([ridge_fit_folds_w(lam, X, y[r], Wk[r],
                                              row_block=row_block,
                                              strategy=strategy)
                            for r in range(y.shape[0])])
    q = X.shape[1] + 1
    lead = Wk.shape[:-1]
    Gaug, n_eff = moments.fold_weighted_gram(
        X, Wk.reshape(-1, Wk.shape[-1]), intercept=True, append=y,
        row_block=row_block, strategy=strategy)
    n_eff = torch.clamp(n_eff, min=1.0)
    eye = torch.eye(q, dtype=_F32, device=X.device)
    A = Gaug[:, :q, :q] / n_eff[:, None, None] + lam * eye[None]
    b = Gaug[:, :q, q] / n_eff[:, None]
    return det_solve(A, b).reshape(lead + (q,))


def logistic_fit_folds_w(lam: float, iters: int, X: Tensor, t: Tensor,
                         Wk: Tensor, *, row_block: int = 0,
                         strategy: Optional[str] = None) -> Tensor:
    """Weighted Newton logistic for every (…, k) weight row of ``Wk``,
    ``iters`` steps from zero.  Each step takes the reference's two
    Grams: the gradient read off a Gram with the signed weights
    ``Wk·(mu - t)`` over ``[X | 1 | 1]`` (its last column), and the
    Hessian with weights ``Wk·mu(1 - mu)`` over ``[X | 1]``.  Returns
    beta (…, k, p+1).  The target enters through the weights alone, so
    it may carry a leading replicate axis, t (R, n) beside Wk (R, k, n),
    in the same batched fit."""
    Xa = _aug(X.to(_F32))
    n, q = Xa.shape
    lead = Wk.shape[:-1]
    W = Wk.reshape(-1, n).to(_F32)
    tt = t.to(_F32)
    if tt.dim() == 2:
        tt = tt[:, None, :].expand(Wk.shape).reshape(-1, n)
    else:
        tt = tt[None, :]
    n_eff = torch.clamp(W.sum(1), min=1.0)
    lam_eye = lam * torch.eye(q, dtype=_F32, device=X.device)
    ones = torch.ones((n,), dtype=_F32, device=X.device)
    beta = torch.zeros((W.shape[0], q), dtype=_F32, device=X.device)
    for _ in range(iters):
        mu = _predict(beta, Xa, logistic=True)                 # (M, n)
        s = torch.clamp(mu * (1.0 - mu), min=1e-6) * W
        Gr, _ = moments.fold_weighted_gram(
            Xa, W * (mu - tt), append=ones, row_block=row_block,
            strategy=strategy)
        g = Gr[:, :q, q] / n_eff[:, None] + lam * beta
        H, _ = moments.fold_weighted_gram(X, s, intercept=True,
                                          row_block=row_block,
                                          strategy=strategy)
        H = H / n_eff[:, None, None] + lam_eye[None]
        beta = beta - det_solve(H, g)
    return beta.reshape(lead + (q,))


def predict_folds_linear(beta: Tensor, X: Tensor) -> Tensor:
    """(…, p+1) coefficients -> (…, n) linear predictions."""
    return _predict(beta, _aug(X.to(_F32)))


def predict_folds_logistic(beta: Tensor, X: Tensor) -> Tensor:
    """(…, p+1) coefficients -> (…, n) probabilities."""
    return _predict(beta, _aug(X.to(_F32)), logistic=True)


# ---------------------------------------------------------------------------
# Weighted final stages.  ry, rt, rz, w: (n,) or (R, n); phi (n, p_phi).
# ---------------------------------------------------------------------------

def sandwich(A: Tensor, meat: Tensor) -> Tensor:
    """HC0 covariance A⁻¹ · meat · A⁻¹ over any leading batch, by the
    Gauss-Jordan inverse and elementwise products (batch-invariant)."""
    Ainv = det_inv(A)
    return _small_mm(_small_mm(Ainv, meat), Ainv)


def _sandwich_se(A: Tensor, meat: Tensor) -> Tensor:
    cov = sandwich(A, meat)
    return torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                                  min=0.0))


def weighted_theta(ry: Tensor, rt: Tensor, phi: Tensor, w: Tensor, *,
                   ridge: float = 1e-8, with_se: bool = True,
                   row_block: int = 0, strategy: Optional[str] = None
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """Solve the weighted orthogonal moment
    ``theta = argmin Σ w_i (ry_i - <theta, phi_i> rt_i)²`` and, with
    ``with_se``, its weighted HC0 sandwich stderr.  Returns (theta, se),
    each (p_phi,) or (R, p_phi)."""
    p = phi.shape[1]
    Gaug, n_eff = moments.residual_weighted_gram(
        ry, rt, phi, w, row_block=row_block, strategy=strategy)
    n_eff = torch.clamp(n_eff, min=1.0)
    eye = torch.eye(p, dtype=_F32, device=phi.device)
    A = Gaug[..., :p, :p] + ridge * n_eff[..., None, None] * eye
    theta = det_solve(A, Gaug[..., :p, p])
    if not with_se:
        return theta, None
    # the residuals are given, so the meat's nuisances are zero
    meat = moments.residual_meat(ry, rt, torch.zeros_like(ry),
                                 torch.zeros_like(rt), phi, theta, w=w,
                                 row_block=row_block, strategy=strategy)
    return theta, _sandwich_se(A, meat)


def weighted_iv_theta(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor,
                      w: Tensor, *, ridge: float = 1e-8,
                      with_se: bool = True, row_block: int = 0,
                      strategy: Optional[str] = None
                      ) -> Tuple[Tensor, Optional[Tensor]]:
    """Solve the weighted instrumented moment
    ``Σ w_i rz_i φ_i (ry_i - <theta, φ_i> rt_i) = 0`` (residual-on-
    residual 2SLS) and, with ``with_se``, its weighted HC0 sandwich
    stderr, off one instrumented augmented Gram and one meat pass."""
    p = phi.shape[1]
    Gaug, n_eff = moments.iv_gram(ry, rt, rz, phi, w, row_block=row_block,
                                  strategy=strategy)
    J, b, _, _ = moments.iv_slices(Gaug, p)
    n_eff = torch.clamp(n_eff, min=1.0)
    eye = torch.eye(p, dtype=_F32, device=phi.device)
    A = J + ridge * n_eff[..., None, None] * eye
    theta = det_solve(A, b)
    if not with_se:
        return theta, None
    meat = moments.iv_meat(ry, rt, rz, phi, theta, w=w, row_block=row_block,
                           strategy=strategy)
    return theta, _sandwich_se(A, meat)
