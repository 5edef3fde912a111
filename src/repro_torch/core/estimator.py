"""The estimator base layer: the fit -> inference plumbing of effect
results.

``EffectResult`` resolves the inference method from the config, caches
InferenceResults per (method, replicates, executor), and falls back to
the analytic interval when inference is off.  Estimators plug in only
``_replicate_inference``.  ``SandwichEffectResult`` adds theta + HC0
covariance (DML, OrthoIV); ``PseudoOutcomeEffectResult`` a scalar ATE
(the mean pseudo-outcome) beside a theta projection (DRLearner, DRIV).
Replicate inference: the delete-fold jackknife, and the pairs
("bootstrap") and multiplier bootstraps through the task runtime
(``repro_torch.inference``, ``repro_torch.runtime``).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.final_stage import cate_basis
from repro_torch.device import as_f32

Tensor = torch.Tensor


def resolve_scheme(method: str) -> str:
    """Inference-method name -> bootstrap weight scheme ("bootstrap" is
    the user-facing name of the pairs scheme)."""
    return "pairs" if method == "bootstrap" else method


def inf_cache_field() -> Any:
    """The per-result InferenceResult cache field (out of repr/eq)."""
    return dataclasses.field(default_factory=dict, repr=False, compare=False)


@runtime_checkable
class CausalEstimator(Protocol):
    """Every estimator facade: constructed with a CausalConfig, ``fit``
    returns an EffectResult.  The data arguments differ by family — DML
    takes (y, t, X), the IV family (y, t, z, X) — hence the registry's
    per-estimator ``fit_adapter``."""

    cfg: CausalConfig

    def fit(self, *args: Any, **kwargs: Any) -> "EffectResult":
        ...


def fit_adapter(estimator_cls: Callable[..., Any], *fields: str
                ) -> Callable[..., Any]:
    """The registry's uniform ``fit(data, cfg, gen) -> EffectResult``:
    ``estimator_cls(cfg, device=data.X.device).fit(*columns, gen=gen)``
    with the columns ``fields`` read off ``data`` (the reference passes
    a key where the port passes a ``torch.Generator``)."""

    def fit(data: Any, cfg: CausalConfig,
            gen: Optional[torch.Generator]) -> Any:
        cols = [getattr(data, f) for f in fields]
        return estimator_cls(cfg, device=data.X.device).fit(*cols, gen=gen)

    return fit


class EffectResult:
    """Mixin owning the shared fit -> inference plumbing.  Subclass
    dataclasses provide ``cfg``, ``fit_ctx`` and ``_inf_cache``."""

    estimator_name = "effect"

    def _config(self) -> CausalConfig:
        return self.cfg or CausalConfig()

    def _runtime_kwargs(self) -> Dict[str, Any]:
        """The task runtime's knobs every replicate dispatch takes:
        ``runtime_chunk`` replicates per batched call (else the memory
        model's chunk under ``runtime_memory_budget``) and
        ``runtime_max_retries`` rungs of the downgrade ladder."""
        cfg = self._config()
        return dict(memory_budget=cfg.runtime_memory_budget,
                    chunk=cfg.runtime_chunk,
                    max_retries=cfg.runtime_max_retries)

    def _resolve_method(self, method: str) -> str:
        """Map or refuse inference methods the estimator cannot serve
        (DR has no fold-state jackknife)."""
        return method

    def _replicate_inference(self, method: str, n_boot: int, executor: Any,
                             alpha: float):
        raise NotImplementedError

    def _analytic_ate_interval(self, alpha: float) -> Tuple[float, float]:
        raise ValueError(f"{type(self).__name__} has no analytic ATE interval")

    def _analytic_cate_interval(self, phi: Tensor, alpha: float
                                ) -> Tuple[Tensor, Tensor]:
        raise ValueError(f"{type(self).__name__} has no analytic CATE band")

    def _summary_extra(self) -> Tuple[str, ...]:
        return ()

    def inference(self, *, method: Optional[str] = None,
                  n_bootstrap: Optional[int] = None,
                  executor: Optional[str] = None,
                  alpha: Optional[float] = None):
        """Replicate-based inference, computed lazily and cached (alpha
        is not part of the key: a new level re-reads the same draws)."""
        if self.fit_ctx is None:
            raise ValueError("result carries no fit context; re-fit through "
                             "the estimator facade to enable inference")
        cfg = self._config()
        method = method or cfg.inference
        if method in ("none", ""):
            raise ValueError("cfg.inference='none'; pass method= to force")
        method = self._resolve_method(method)
        n_boot = n_bootstrap or cfg.n_bootstrap
        exe = executor or cfg.inference_executor
        a = cfg.alpha if alpha is None else alpha
        cache_key = (method, n_boot, exe)
        if cache_key not in self._inf_cache:
            self._inf_cache[cache_key] = self._replicate_inference(
                method, n_boot, exe, a)
        return self._inf_cache[cache_key]

    def ate_interval(self, alpha: Optional[float] = None,
                     kind: str = "percentile") -> Tuple[float, float]:
        """(lo, hi) CI for the ATE functional; analytic when
        cfg.inference == 'none'."""
        cfg = self._config()
        a = cfg.alpha if alpha is None else alpha
        if self.fit_ctx is None or cfg.inference in ("none", ""):
            return self._analytic_ate_interval(a)
        return self.inference(alpha=a).ate_interval(a, kind)

    # the IV family's name for the same functional
    late_interval = ate_interval

    def cate_interval(self, X: Tensor, alpha: Optional[float] = None
                      ) -> Tuple[Tensor, Tensor]:
        """Pointwise (lo, hi) bands for theta(x) = <phi(x), theta>, on
        theta's device (subclasses provide ``theta``)."""
        cfg = self._config()
        a = cfg.alpha if alpha is None else alpha
        phi = cate_basis(as_f32(X, self.theta.device), cfg.cate_features)
        if self.fit_ctx is None or cfg.inference in ("none", ""):
            return self._analytic_cate_interval(phi, a)
        return self.inference(alpha=a).cate_interval(phi, a)


class SandwichEffectResult(EffectResult):
    """theta + HC0 sandwich covariance (subclasses provide ``theta``
    (p_phi,) and ``cov`` (p_phi, p_phi))."""

    @property
    def ate(self) -> float:
        """theta[0]: the ATE under the constant basis."""
        return float(self.theta[0])

    @property
    def late(self) -> float:
        """theta[0] read as the IV family's LATE."""
        return self.ate

    @property
    def stderr(self) -> Tensor:
        """Sandwich standard errors."""
        return torch.sqrt(torch.diagonal(self.cov))

    def cate(self, X: Tensor) -> Tensor:
        """theta(x) = <phi(x), theta> per row of X (moved to theta's
        device)."""
        phi = cate_basis(as_f32(X, self.theta.device),
                         self._config().cate_features)
        return phi @ self.theta

    def ate_of(self, X: Tensor) -> float:
        """Mean CATE over the rows of X."""
        return float(self.cate(X).mean())

    def conf_int(self, alpha: float = 0.05) -> Tuple[Tensor, Tensor]:
        """Analytic per-coefficient CI from the sandwich."""
        from repro_torch.inference.intervals import z_crit
        z = z_crit(alpha)
        return self.theta - z * self.stderr, self.theta + z * self.stderr

    def _analytic_ate_interval(self, alpha: float) -> Tuple[float, float]:
        lo, hi = self.conf_int(alpha)
        return float(lo[0]), float(hi[0])

    def _analytic_cate_interval(self, phi: Tensor, alpha: float
                                ) -> Tuple[Tensor, Tensor]:
        from repro_torch.inference.intervals import z_crit
        z = z_crit(alpha)
        se = torch.sqrt(torch.clamp(((phi @ self.cov) * phi).sum(1), min=0.0))
        c = phi @ self.theta
        return c - z * se, c + z * se

    def summary(self) -> str:
        """A printable coefficient table plus diagnostics."""
        lo, hi = self.conf_int()
        lines = [f"{self.estimator_name} result", "-" * 46,
                 f"{'coef':>4} {'point':>10} {'stderr':>10} {'ci_lo':>9} "
                 f"{'ci_hi':>9}"]
        for i in range(self.theta.shape[0]):
            lines.append(f"θ[{i}] {float(self.theta[i]):>10.4f} "
                         f"{float(self.stderr[i]):>10.4f} "
                         f"{float(lo[i]):>9.4f} {float(hi[i]):>9.4f}")
        extra = self._summary_extra()
        if extra:
            lines.append("-" * 46)
            lines.extend(extra)
        return "\n".join(lines)



class PseudoOutcomeEffectResult(EffectResult):
    """Scalar ATE = the mean pseudo-outcome, beside a theta projection on
    phi (subclass dataclasses provide ``ate``, ``stderr`` (floats) and
    ``theta`` (p_phi,))."""

    def cate(self, X: Tensor, n_features: Optional[int] = None) -> Tensor:
        """theta(x) = <phi(x), theta> per row of X (on theta's device)."""
        nf = (n_features if n_features is not None
              else self._config().cate_features)
        return cate_basis(as_f32(X, self.theta.device), nf) @ self.theta

    def conf_int(self, alpha: float = 0.05) -> Tuple[float, float]:
        """Analytic ATE interval: ate ± z · stderr."""
        from repro_torch.inference.intervals import z_crit
        z = z_crit(alpha)
        return self.ate - z * self.stderr, self.ate + z * self.stderr

    def _analytic_ate_interval(self, alpha: float) -> Tuple[float, float]:
        return self.conf_int(alpha)

    def summary(self) -> str:
        """The ATE with its analytic interval, plus diagnostics."""
        lo, hi = self.conf_int()
        lines = [f"{self.estimator_name} result", "-" * 46,
                 f"ATE = {self.ate:+.4f} (se {self.stderr:.4f}), "
                 f"95% CI [{lo:+.4f}, {hi:+.4f}]"]
        lines.extend(self._summary_extra())
        return "\n".join(lines)
