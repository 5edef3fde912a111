"""Orthogonal final stage: the Neyman-orthogonal moment solved as normal
equations on residuals.

    ry = y - m_y(X),  rt = t - m_t(X),  Z = rt ⊙ phi(X)
    theta = argmin  Σ (ry - <theta, phi>·rt)²   ⇒   (ZᵀZ)θ = Zᵀry

  row_block = 0   the fused ``residual_gram`` (the kernel on the card)
                  gives G, b; the HC0 meat is a plain product over the
                  materialized (n, p_phi) Z.
  row_block = R   both passes (G/b, then the meat at the solved theta)
                  stream in row blocks — through the fused kernel under
                  ``strategy="pallas"``.

Inference: the heteroskedasticity-robust (HC0) sandwich covariance.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import moments
from repro_torch.distributed.sharding import row_sum
from repro_torch.kernels.residual_gram import ops as rg_ops

Tensor = torch.Tensor
_F32 = torch.float32


def cate_basis(X: Tensor, n_features: int) -> Tensor:
    """phi(x): [1] (constant effect) or [1, x_0..x_{m-1}]."""
    ones = torch.ones_like(X[:, :1], dtype=_F32)
    if n_features <= 1:
        return ones
    return torch.cat([ones, X[:, :n_features - 1].to(_F32)], dim=1)


@dataclasses.dataclass(frozen=True)
class FinalStageResult:
    """Final-stage coefficients, HC0 covariance and the scaled Gram."""

    theta: Tensor       # (p_phi,)
    cov: Tensor         # (p_phi, p_phi) HC0 sandwich
    gram: Tensor        # (p_phi, p_phi) ZᵀZ / n
    n: int

    @property
    def stderr(self) -> Tensor:
        """Sandwich standard errors."""
        return torch.sqrt(torch.diagonal(self.cov))


def _hc0_meat(y: Tensor, t: Tensor, my: Tensor, mt: Tensor, phi: Tensor,
              theta: Tensor) -> Tensor:
    """``Zᵀ diag(e²) Z`` with ``z = rt·phi`` and ``e = ry - z·theta``."""
    ry = (y - my).to(_F32)
    rt = (t - mt).to(_F32)
    z = rt[:, None] * phi.to(_F32)
    e = ry - z @ theta
    return (z * torch.square(e)[:, None]).T @ z


def fit_final_stage(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                    phi: Tensor, *, ridge: float = 1e-8, row_block: int = 0,
                    strategy: Optional[str] = None) -> FinalStageResult:
    """Solve the orthogonal moment.  y, t, my, mt: (n,); phi: (n, p_phi)."""
    n, p = phi.shape
    eye = torch.eye(p, dtype=_F32, device=phi.device)
    r = moments.resolve_row_block(n, row_block)
    if r > 0:
        G, b = moments.residual_moments(y, t, my, mt, phi, row_block=r,
                                        strategy=strategy)
        A = G + ridge * n * eye
        theta = torch.linalg.solve(A, b)
        meat = moments.residual_meat(y, t, my, mt, phi, theta, row_block=r,
                                     strategy=strategy)
        Ainv = torch.linalg.inv(A)
        return FinalStageResult(theta=theta, cov=Ainv @ meat @ Ainv,
                                gram=G / n, n=n)

    G, b = row_sum(rg_ops.residual_gram, y, t, my, mt, phi)
    A = G + ridge * n * eye
    theta = torch.linalg.solve(A, b)
    # HC0 sandwich: cov = A⁻¹ (Zᵀ diag(e²) Z) A⁻¹
    meat = row_sum(_hc0_meat, y, t, my, mt, phi, theta)
    Ainv = torch.linalg.inv(A)
    return FinalStageResult(theta=theta, cov=Ainv @ meat @ Ainv, gram=G / n,
                            n=n)
