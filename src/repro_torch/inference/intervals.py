"""Confidence intervals from replicate draws and the InferenceResult
attached to estimator results.

This slice serves the delete-fold jackknife, whose k draws always take
the normal interval with their jackknife se.  The bootstrap's
percentile and studentized intervals land with the bootstrap slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def z_crit(alpha: float) -> float:
    """Two-sided normal critical value z_{1-α/2}."""
    if alpha == 0.05:
        return 1.959963984540054
    return float(torch.special.ndtri(
        torch.tensor(1.0 - alpha / 2.0, dtype=torch.float64)))


def _later(kind: str):
    return NotImplementedError(
        f"{kind} intervals land with the bootstrap-inference slice "
        "(ROADMAP A.5); this slice serves the jackknife")


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    """Uncertainty quantification for a (p_phi,) coefficient vector:
    ``replicates`` holds the re-estimated thetas (jackknife: the k
    delete-fold thetas), ``se`` the replicate-based stderr."""

    method: str                              # jackknife (bootstrap: later)
    executor: str
    point: Tensor                            # (p_phi,)
    replicates: Tensor                       # (B, p_phi)
    se: Tensor                               # (p_phi,)
    alpha: float = 0.05
    point_se: Optional[Tensor] = None        # (p_phi,) sandwich stderr

    @property
    def n_replicates(self) -> int:
        """Number of replicate draws."""
        return int(self.replicates.shape[0])

    def interval(self, alpha: Optional[float] = None,
                 kind: str = "percentile") -> Tuple[Tensor, Tensor]:
        """Per-coefficient (lo, hi)."""
        a = self.alpha if alpha is None else alpha
        if self.method == "jackknife" or kind == "normal":
            z = z_crit(a)
            return self.point - z * self.se, self.point + z * self.se
        raise _later(kind)

    def ate_interval(self, alpha: Optional[float] = None,
                     kind: str = "percentile") -> Tuple[float, float]:
        """CI for theta[0] (the ATE under the constant CATE basis)."""
        lo, hi = self.interval(alpha, kind)
        return float(lo[0]), float(hi[0])

    def cate_interval(self, phi: Tensor, alpha: Optional[float] = None
                      ) -> Tuple[Tensor, Tensor]:
        """Pointwise bands for phi @ theta: (n, p_phi) -> ((n,), (n,))."""
        a = self.alpha if alpha is None else alpha
        phi = phi.to(torch.float32)
        draws = self.replicates @ phi.T                       # (B, n)
        if self.method == "jackknife":
            z = z_crit(a)
            center = phi @ self.point
            k = draws.shape[0]
            dev = torch.sqrt(torch.clamp((k - 1.0) / k * torch.square(
                draws - draws.mean(0, keepdim=True)).sum(0), min=0.0))
            return center - z * dev, center + z * dev
        raise _later("percentile")
