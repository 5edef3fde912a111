"""SweepSpec: the (segments × estimator-configs) grid of one sweep.

The paper's case study — and the industrial workloads it stands in for
(Netflix's "estimate many effects cheaply", Amazon's DML-at-scale
batches) — is not one estimation but E × C of them: every user segment
/ treatment cohort crossed with every estimator-config variant.  A
``SweepSpec`` names that grid; ``repro_torch.sweep.engine.sweep``
executes it as batched programs instead of a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.kernels.seg_gram import ops as sg_ops


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep's grid.

    n_segments   E: cells run per segment id in [0, E) (ids come in as
                 a per-row integer tensor at ``sweep()`` time — segments
                 with no rows produce flagged, not crashing, cells).
    columns      the estimator-config axis: (registry name, config)
                 pairs.  Columns may mix estimator families.
    segment_key  provenance only — the name of the cohort column in the
                 caller's frame (CausalConfig.segment_key); the engine
                 itself consumes the integer id tensor.
    """

    n_segments: int
    columns: Tuple[Tuple[str, CausalConfig], ...]
    segment_key: str = ""

    def __post_init__(self):
        if self.n_segments < 1:
            raise ValueError(f"n_segments must be >= 1, got {self.n_segments}")
        if not self.columns:
            raise ValueError("a sweep needs at least one (estimator, config) column")

    @classmethod
    def grid(cls, n_segments: int, estimators: Tuple[str, ...] = ("dml",),
             configs: Tuple[CausalConfig, ...] = (CausalConfig(),),
             segment_key: str = "") -> "SweepSpec":
        """The full outer product: every estimator × every config."""
        cols = tuple((e, c) for e in estimators for c in configs)
        key = segment_key
        if not key:
            key = next((c.segment_key for c in configs if c.segment_key), "")
        return cls(n_segments=n_segments, columns=cols, segment_key=key)

    @property
    def n_cells(self) -> int:
        """Total grid size E x C."""
        return self.n_segments * len(self.columns)


def segment_counts(segment_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(E,) int64 rows per segment — the zero-row diagnostic every panel
    carries; ids outside [0, E) count nowhere."""
    return sg_ops.segment_counts(segment_ids, n_segments).long()
