"""repro_torch.store — the persistent, incrementally-updatable effect store.

Every estimator here bottoms out in Gram-additive sufficient
statistics; this package makes that additivity operational for the
daily-refresh workload.  A ``MomentStore`` keeps per-(segment, fold)
nuisance and final-stage moment accumulators for every column of a
``SweepSpec``; ``ingest`` folds each newly arrived row block into them
with one pass over only the new rows (history is never re-read), and
``refresh`` re-solves thetas/SEs in O(p³) per cell and emits a fresh
``EffectPanel``.  At canonical row-blocked shapes the incremental
"chunked" path is *bitwise identical* to a full refit on the
concatenated data, and on the card the "pallas" path's seeded segment
walk is too; versioned snapshots ride through
``repro_torch.checkpoint`` for hot-swap/rollback.  Coverage is gated by
``store_supported`` (all-ridge DML and OrthoIV families); unsupported
columns fault-isolate as failed panel columns.
"""

from repro_torch.store.stats import ColumnLayout
from repro_torch.store.store import MomentStore, store_supported

__all__ = ["ColumnLayout", "MomentStore", "store_supported"]
