"""Refresh-side solves: cell accumulators → per-segment effects.

Everything here is O(p³)-per-cell linear algebra on the store's
sufficient statistics — no data pass:

  1. Cross-fit ridge nuisances come from the fold-complement of the
     nuisance Gram (the leave-one-out identity of
     ``sweep.segmented._segment_fold_ridge``, same scaling: complement
     Gram / n_eff + λI).
  2. Residuals are linear forms of the design, ``r = cᵀ dn`` with
     coefficient vectors like ``c_y = [-β_y | 1 at the y column]``, so
     every final-stage moment is a contraction of the degree-4 tensor
     ``vg`` with two coefficient vectors:

        G   = Σ rt²·φφᵀ      = ⟨vg, c_t ⊗ c_t⟩
        b   = Σ rt·ry·φ      = ⟨vg, c_t ⊗ c_y⟩  (φ₀ ≡ 1 carries ry)
        J   = Σ rz·rt·φφᵀ    = ⟨vg, c_z ⊗ c_t⟩  (instrumented family)
        Σe² = Σry² - 2θᵀb + θᵀGθ

  3. Solve/invert with the deterministic Gauss-Jordan of
     ``inference.numerics`` and the exact ridge scaling of the
     segmented sweep (``+ 1e-8·n_seg·I``).

Standard errors are the **homoskedastic** sandwich ``σ²·A⁻¹ G A⁻¹``
(σ² = Σe²/n_seg): the HC0 meat is degree-6 in the design and is not a
contraction of any stored moment.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.inference.numerics import det_inv, det_solve
from repro_torch.store.stats import ColumnLayout, State

Tensor = torch.Tensor
_F32 = torch.float32


def _coef(beta: Tensor, col: int, qd: int, q: int) -> Tensor:
    """Residual coefficient vector in dn coordinates: r = cᵀ dn."""
    c = torch.zeros(beta.shape[:-1] + (qd,), dtype=beta.dtype,
                    device=beta.device)
    c[..., :q] = -beta
    c[..., col] = 1.0
    return c


def refresh_column(layout: ColumnLayout, state: State, n_segments: int, *,
                   ridge_lambda: float, ridge_final: float = 1e-8
                   ) -> Dict[str, Tensor]:
    """Re-solve one column: {"theta" (E, pf), "se" (E, pf), "ate" (E,)}.

    Zero-row cells stay finite (n_eff/n_seg floored at 1, ridge keeps
    every solve well-posed); ``EffectPanel.ok`` flags them via counts.
    """
    lo = layout
    E, k, q, qd, pf = n_segments, lo.k, lo.q, lo.qd, lo.pf
    dev = state["ng"].device
    ng = state["ng"].reshape(E, k, qd, qd)
    counts = state["counts"].reshape(E, k)

    # fold-complement ridge nuisances (LOO identity, segmented scaling)
    A_aug = ng.sum(dim=1)[:, None] - ng
    n_eff = torch.clamp(counts.sum(1, keepdim=True) - counts, min=1.0)
    A = (A_aug[..., :q, :q] / n_eff[..., None, None]
         + ridge_lambda * torch.eye(q, dtype=_F32, device=dev))

    def _beta_for(col):
        return det_solve(A, A_aug[..., :q, col] / n_eff[..., None])

    cy = _coef(_beta_for(lo.iy), lo.iy, qd, q)
    ct = _coef(_beta_for(lo.it), lo.it, qd, q)

    # final-stage statistics as contractions of the degree-4 tensor
    V6 = state["vg"].reshape(E, k, pf, qd, pf, qd)

    def _quad(ca, cb):
        return torch.einsum("skaibj,ski,skj->sab", V6, ca, cb)

    def _qvec(ca, cb):
        return torch.einsum("skaij,ski,skj->sa", V6[:, :, :, :, 0, :], ca, cb)

    def _qscl(ca, cb):
        return torch.einsum("skij,ski,skj->s", V6[:, :, 0, :, 0, :], ca, cb)

    nseg = torch.clamp(counts.sum(dim=1), min=1.0)
    eye = torch.eye(pf, dtype=_F32, device=dev)
    Gtt = _quad(ct, ct)          # Σ rt²·φφᵀ per segment
    bty = _qvec(ct, cy)          # Σ rt·ry·φ
    syy = _qscl(cy, cy)          # Σ ry²

    if lo.iv:
        cz = _coef(_beta_for(lo.iz), lo.iz, qd, q)
        a = _quad(cz, ct) + ridge_final * nseg[:, None, None] * eye
        theta = det_solve(a, _qvec(cz, cy))
        meat_base = _quad(cz, cz)   # Σ rz²·φφᵀ — the instrument score Gram
    else:
        a = Gtt + ridge_final * nseg[:, None, None] * eye
        theta = det_solve(a, bty)
        meat_base = Gtt

    sse = syy - 2.0 * (theta * bty).sum(-1) + torch.einsum(
        "sa,sab,sb->s", theta, Gtt, theta)
    sigma2 = torch.clamp(sse, min=0.0) / nseg
    ainv = det_inv(a)
    cov = torch.einsum("sia,sab,sbj->sij", ainv,
                       sigma2[:, None, None] * meat_base, ainv)
    se = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2),
                                min=0.0))
    return {"theta": theta, "se": se, "ate": theta[:, 0]}
