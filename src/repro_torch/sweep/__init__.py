"""repro_torch.sweep — segment-parallel sweeps: the many-cohorts workload.

The paper's case study is not one estimation but many (per user
segment / treatment cohort / config variant).  A ``SweepSpec`` names
the (E segments × C estimator-configs) grid; ``sweep`` runs each cell
as a masked weighted fit through the task runtime (``mode="cells"``,
the default), or solves every DML-family column's E·K fold-complement
normal equations from ONE combined segment×fold Gram pass on the
segment-walking kernel (``mode="segmented"``); results land in an
``EffectPanel`` with per-cell validity instead of exceptions.  The persistent,
incrementally refreshed variant of this panel lives in
``repro_torch.store``.
"""
#   spec.py       SweepSpec — the (segments × estimator-configs) grid
#   engine.py     sweep(): cells mode through the task runtime (masked
#                 weighted cells, replicate CIs via map_product,
#                 serial_loop), segmented mode, per-column isolation
#                 and checkpoints
#   segmented.py  the one-pass segment×fold-Gram fast path (DML family)
#   panel.py      EffectPanel — thetas, diagnostics, per-cell failure
#                 status
from repro_torch.sweep.spec import SweepSpec, segment_counts  # noqa: F401
from repro_torch.sweep.panel import ColumnResult, EffectPanel  # noqa: F401
from repro_torch.sweep.engine import column_keys, serial_loop, sweep  # noqa: F401
from repro_torch.sweep.segmented import (  # noqa: F401
    segmented_dml_sweep,
    segmented_supported,
)
