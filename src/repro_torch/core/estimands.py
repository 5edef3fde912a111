"""Orthogonality, overlap and instrument diagnostics of DML and OrthoIV
fits, and the ATE / ATT read off a pointwise CATE."""
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


@dataclasses.dataclass(frozen=True)
class IVDiagnostics:
    """Instrument-side health checks for the orthogonal-IV family."""

    first_stage_f: float     # heteroskedasticity-robust first-stage F
    instrument_corr: float   # corr(rz, rt): the identifying covariance
    resid_z_mean: float      # E[rz] ≈ 0 if m_z unbiased
    ortho_moment: float      # |E[(ry - θᵀφ·rt)·rz]| ≈ 0 (the IV moment)
    min_instrument_propensity: float   # overlap of E[Z|X]
    max_instrument_propensity: float
    weak_instrument: bool    # F below the Stock-Yogo rule of thumb 10

    def rows(self) -> Dict[str, float]:
        """The diagnostics as a plain dict."""
        return dataclasses.asdict(self)


def first_stage_f(rt: torch.Tensor, rz: torch.Tensor) -> float:
    """Robust first-stage F: the squared t-statistic of pi in
    ``rt = pi·rz + u`` with HC0 variance (F < 10 ⇒ weak)."""
    rtf, rzf = rt.to(_F32), rz.to(_F32)
    szz = torch.clamp((rzf * rzf).sum(), min=1e-12)
    pi = (rzf * rtf).sum() / szz
    u = rtf - pi * rzf
    var_pi = (rzf * rzf * u * u).sum() / (szz * szz)
    return float(pi * pi / torch.clamp(var_pi, min=1e-30))


def compute_iv_diagnostics(t, z, mt, mz, e=None, *,
                           f_threshold: float = 10.0) -> IVDiagnostics:
    """``e`` is the final-stage residual ``ry - θᵀφ·rt`` (omit for the
    pre-fit view)."""
    rt = (t - mt).to(_F32)
    rz = (z - mz).to(_F32)
    f_stat = first_stage_f(rt, rz)
    corr = torch.corrcoef(torch.stack([rz, rt]))[0, 1]
    ortho = (float(torch.abs((e.to(_F32) * rz).mean())) if e is not None
             else float("nan"))
    return IVDiagnostics(
        first_stage_f=f_stat,
        instrument_corr=float(corr),
        resid_z_mean=float(rz.mean()),
        ortho_moment=ortho,
        min_instrument_propensity=float(mz.min()),
        max_instrument_propensity=float(mz.max()),
        weak_instrument=bool(f_stat < f_threshold),
    )


def ate_from_cate(cate: torch.Tensor) -> float:
    """The ATE as the mean pointwise CATE."""
    return float(cate.mean())


def att_from_cate(cate: torch.Tensor, t: torch.Tensor) -> float:
    """The effect on the treated: the CATE averaged over treated rows."""
    tw = t.to(_F32)
    return float((cate * tw).sum() / torch.clamp(tw.sum(), min=1.0))
