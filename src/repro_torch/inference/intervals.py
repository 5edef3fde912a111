"""Confidence intervals from replicate draws and the InferenceResult
attached to estimator results.

Three interval families over the (B, p_phi) replicate matrix:

  percentile   empirical (α/2, 1-α/2) quantiles of the draws (EconML's
               ``BootstrapInference`` default), with ``torch.quantile``'s
               linear interpolation — ``jnp.quantile``'s default too;
  normal       point ± z_{1-α/2} · sd(draws);
  studentized  bootstrap-t: quantiles of (θ*_b - θ̂)/se*_b rescaled by
               the point estimate's sandwich stderr.

The delete-fold jackknife's k draws always take the normal interval
with their jackknife se.
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


def percentile_interval(replicates: Tensor, alpha: float = 0.05
                        ) -> Tuple[Tensor, Tensor]:
    """(B, ...) draws -> (lo, hi) empirical (α/2, 1-α/2) quantiles."""
    lo = torch.quantile(replicates, alpha / 2.0, dim=0)
    hi = torch.quantile(replicates, 1.0 - alpha / 2.0, dim=0)
    return lo, hi


def normal_interval(point: Tensor, replicates: Tensor, alpha: float = 0.05
                    ) -> Tuple[Tensor, Tensor]:
    """point ± z · sd(draws) (ddof 1)."""
    se = torch.std(replicates, dim=0, correction=1)
    z = z_crit(alpha)
    return point - z * se, point + z * se


def studentized_interval(point: Tensor, point_se: Tensor,
                         replicates: Tensor, replicate_se: Tensor,
                         alpha: float = 0.05) -> Tuple[Tensor, Tensor]:
    """Bootstrap-t: t*_b = (θ*_b - θ̂)/se*_b; the CI is
    [θ̂ - q_{1-α/2}(t*)·se(θ̂), θ̂ - q_{α/2}(t*)·se(θ̂)]."""
    tstar = (replicates - point[None]) / torch.clamp(replicate_se, min=1e-12)
    q_lo = torch.quantile(tstar, alpha / 2.0, dim=0)
    q_hi = torch.quantile(tstar, 1.0 - alpha / 2.0, dim=0)
    return point - q_hi * point_se, point - q_lo * point_se


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    """Uncertainty quantification for a (p_phi,) coefficient vector:
    ``replicates`` holds the re-estimated thetas (bootstrap: B weighted
    refits; jackknife: the k delete-fold thetas), ``se`` the
    replicate-based stderr.  CIs of derived quantities (ATE = theta[0]
    under the constant basis, CATE = phi(x)·theta) push each draw
    through the functional."""

    method: str                              # pairs|multiplier|jackknife
    executor: str                            # serial|vmap|batched
    point: Tensor                            # (p_phi,)
    replicates: Tensor                       # (B, p_phi)
    se: Tensor                               # (p_phi,)
    alpha: float = 0.05
    point_se: Optional[Tensor] = None        # (p_phi,) sandwich stderr
    replicate_se: Optional[Tensor] = None    # (B, p_phi) for bootstrap-t
    # estimators whose ATE is not theta[0] supply the ATE functional's
    # own draws, so ate_interval centers on what the result reports
    ate_replicates: Optional[Tensor] = None  # (B,)
    ate_point: Optional[float] = None

    @property
    def n_replicates(self) -> int:
        """Number of replicate draws."""
        return int(self.replicates.shape[0])

    def interval(self, alpha: Optional[float] = None,
                 kind: str = "percentile") -> Tuple[Tensor, Tensor]:
        """Per-coefficient (lo, hi)."""
        a = self.alpha if alpha is None else alpha
        if self.method == "jackknife" or kind == "normal":
            # k jackknife draws are far too few for quantiles
            z = z_crit(a)
            return self.point - z * self.se, self.point + z * self.se
        if kind == "percentile":
            return percentile_interval(self.replicates, a)
        if kind == "studentized":
            if self.replicate_se is None or self.point_se is None:
                raise ValueError("studentized CI needs per-replicate "
                                 "stderrs (with_se=True)")
            return studentized_interval(self.point, self.point_se,
                                        self.replicates, self.replicate_se,
                                        a)
        raise ValueError(f"unknown interval kind {kind!r}")

    def ate_interval(self, alpha: Optional[float] = None,
                     kind: str = "percentile") -> Tuple[float, float]:
        """CI for the ATE: theta[0] under the constant CATE basis, or the
        ATE functional's own draws where the estimator supplied them."""
        a = self.alpha if alpha is None else alpha
        if self.ate_replicates is not None:
            draws = self.ate_replicates
            if kind == "normal" or self.method == "jackknife":
                center = (float(draws.mean()) if self.ate_point is None
                          else self.ate_point)
                z = z_crit(a)
                se = float(torch.std(draws, correction=1))
                return center - z * se, center + z * se
            lo, hi = percentile_interval(draws, a)
            return float(lo), float(hi)
        lo, hi = self.interval(alpha, kind)
        return float(lo[0]), float(hi[0])

    # the IV family's name for the same functional
    late_interval = ate_interval

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
        return percentile_interval(draws, a)
