"""EffectPanel: the result container of one sweep — E × C estimates
with CIs, diagnostics, and per-cell failure status.

Per-cell validity is a first-class output, not an exception: a segment
with no rows (or a non-finite solve) flags its cells ``ok = False``
while every other cell keeps its estimate, and a column that fails is
recorded as a failed column without poisoning its neighbors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.config import CausalConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ColumnResult:
    """One (estimator, config) column of the panel: per-segment tensors,
    or an error string when the whole column failed."""

    estimator: str
    cfg: CausalConfig
    thetas: Optional[Tensor] = None  # (E, p_phi)
    ates: Optional[Tensor] = None  # (E,)
    ses: Optional[Tensor] = None  # (E, p_phi)
    ci_lo: Optional[Tensor] = None  # (E,) replicate ATE CI
    ci_hi: Optional[Tensor] = None  # (E,)
    replicates: Optional[Tensor] = None  # (E, B, p_phi)
    key_index: int = 0  # column index of the key lineage
    shared_nuisance: bool = False  # residuals reused from key_index
    events: Tuple[str, ...] = ()  # execution tags ("segmented", "restored")
    error: Optional[str] = None
    # store-refreshed columns only: True = every ingest of this column
    # ended on a row_block boundary (bitwise regime), False = at least
    # one misaligned ingest (tolerance regime), None = not applicable
    # (sweep columns, failed columns)
    aligned: Optional[bool] = None

    @property
    def failed(self) -> bool:
        """Whether this column errored (its cells carry no estimates)."""
        return self.error is not None

    def ok(self, counts: Tensor) -> Tensor:
        """(E,) per-cell validity: the column ran, the segment has rows,
        and the estimate is finite."""
        if self.failed or self.thetas is None:
            return torch.zeros(counts.shape[0], dtype=torch.bool,
                               device=counts.device)
        finite = torch.isfinite(self.thetas).all(dim=-1)
        return (counts.to(finite.device) > 0) & finite


@dataclasses.dataclass(frozen=True)
class EffectPanel:
    """E segments × C estimator-config columns of effect estimates."""

    columns: Tuple[ColumnResult, ...]
    counts: Tensor  # (E,) rows per segment
    n_segments: int
    segment_key: str = ""

    @property
    def n_columns(self) -> int:
        """Number of estimator-config columns C."""
        return len(self.columns)

    def ok(self) -> Tensor:
        """(E, C) per-cell validity mask."""
        return torch.stack([c.ok(self.counts) for c in self.columns], dim=1)

    def ate_table(self) -> Tensor:
        """(E, C) ATE/LATE point estimates; failed columns are NaN."""
        dev = self.counts.device
        cols = [c.ates.to(dev) if c.ates is not None else
                torch.full((self.n_segments,), float("nan"), device=dev)
                for c in self.columns]
        return torch.stack(cols, dim=1)

    def failures(self) -> Tuple[Tuple[int, str], ...]:
        """(column index, error) for every failed column."""
        return tuple((i, c.error) for i, c in enumerate(self.columns)
                     if c.failed)

    def summary(self) -> str:
        """Human-readable panel overview (shape, validity, failures)."""
        ok = self.ok()
        head = (f"EffectPanel: {self.n_segments} segments x "
                f"{self.n_columns} columns")
        if self.segment_key:
            head += f" (segment_key={self.segment_key!r})"
        lines = [
            head,
            f"rows/segment: min {int(self.counts.min())}, "
            f"max {int(self.counts.max())}; "
            f"valid cells {int(ok.sum())}/{ok.numel()}",
            "-" * 60,
        ]
        table = self.ate_table()
        for j, col in enumerate(self.columns):
            if col.failed:
                lines.append(f"[{j}] {col.estimator}: FAILED ({col.error})")
                continue
            good = ok[:, j]
            denom = max(int(good.sum()), 1)
            mean = float(torch.where(good, table[:, j],
                                     torch.zeros_like(table[:, j])).sum()
                         / denom)
            tag = " (shared nuisances)" if col.shared_nuisance else ""
            if col.aligned is False:
                tag += " (misaligned ingest: tolerance regime)"
            lines.append(
                f"[{j}] {col.estimator} p_phi={col.cfg.cate_features}: "
                f"mean ATE {mean:+.4f} over {int(good.sum())} segments{tag}")
        return "\n".join(lines)
