"""Orthogonality and overlap diagnostics of a DML fit."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    """Residual, orthogonality and overlap health checks."""

    resid_y_mean: float      # E[ry] ≈ 0 if m_y unbiased
    resid_t_mean: float      # E[rt] ≈ 0 if m_t unbiased
    resid_corr: float        # corr(ry, rt) pre-final-stage
    ortho_moment: float      # |E[(ry - θ·rt)·rt]| ≈ 0 (Neyman orthogonality)
    min_propensity: float    # overlap
    max_propensity: float
    nuisance_r2_y: float     # 1 - Var(ry)/Var(y)
    nuisance_auc_proxy: float  # mean |mt - 0.5|·2 (separation proxy)

    def rows(self) -> Dict[str, float]:
        """The diagnostics as a plain dict."""
        return dataclasses.asdict(self)


def _var(x: torch.Tensor) -> torch.Tensor:
    """Population variance (ddof 0, as jnp.var)."""
    return torch.var(x, correction=0)


def compute_diagnostics(y, t, my, mt, theta_at_x,
                        rt_clip: float = 1e-9) -> Diagnostics:
    """Diagnostics from the data, the out-of-fold nuisances and
    theta(x_i)."""
    ry = (y - my).to(_F32)
    rt = (t - mt).to(_F32)
    e = ry - theta_at_x.to(_F32) * rt
    corr = torch.corrcoef(torch.stack([ry, rt]))[0, 1]
    var_y = torch.clamp(_var(y.to(_F32)), min=rt_clip)
    return Diagnostics(
        resid_y_mean=float(ry.mean()),
        resid_t_mean=float(rt.mean()),
        resid_corr=float(corr),
        ortho_moment=float(torch.abs((e * rt).mean())),
        min_propensity=float(mt.min()),
        max_propensity=float(mt.max()),
        nuisance_r2_y=float(1.0 - _var(ry) / var_y),
        nuisance_auc_proxy=float((torch.abs(mt - 0.5) * 2).mean()),
    )
