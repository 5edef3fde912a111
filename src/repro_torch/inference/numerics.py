"""Deterministic small solves for replicate inference.

Gauss-Jordan elimination without pivoting, written as broadcast rank-1
updates over any leading batch dimensions: the k delete-fold solves of
the jackknife run as one batched call, and each replicate's arithmetic
is the same whether it is solved alone or in a batch.  Every system
solved here is SPD plus an explicit ridge, so no pivoting is needed.
The fold-batched weighted fits of this module land with the bootstrap
slice.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


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
