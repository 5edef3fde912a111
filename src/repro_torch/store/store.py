"""MomentStore: the persistent, incrementally-updatable effect store.

Lifecycle::

    store = MomentStore(spec, n_features=p, seed=0)
    store.ingest(X=day0.X, y=day0.y, t=day0.t, segment_ids=sids0)
    panel_v1 = store.refresh()            # EffectPanel, O(p³) per cell
    store.save(manager)                   # versioned snapshot (v1)
    store.ingest(X=day1.X, ...)           # one pass over ONLY new rows
    panel_v2 = store.refresh()
    store.restore(manager, step=1)        # rollback / hot-swap

Contracts:

  * **Bitwise ingest invariance** — at canonical row-blocked shapes
    (``cfg.row_block = R > 0``, every ingest except the last a
    multiple of R), any partition of the rows into ingest blocks
    yields bit-identical accumulators AND a bit-identical refreshed
    panel to the single-ingest rebuild on the "chunked" strategy (the
    fixed-order block fold of ``moments.blocked_reduce`` seeded with
    the standing accumulators).  On the card, "pallas" ingest holds it
    for any partition (the seeded, unsplit segment walk).  Misaligned
    ingests stay correct but only tolerance-equal; alignment is tracked
    PER COLUMN (``store.column_aligned``, and each refreshed
    ``ColumnResult``'s ``aligned`` flag), with ``store.aligned`` as the
    all-columns rollup.
  * **Streaming-stable folds** — a row's fold is splitmix64(column
    seed, global row index) mod k: it depends only on the row's global
    arrival index, never on rows that arrive later (a balanced
    permutation depends on the total n and would reshuffle history).
    torch cannot replay the reference's ``jax.random.fold_in`` draw, so
    the folds differ from the reference's; parity tests hand the
    reference's folds in by replacing ``_row_folds``.
  * **Coverage gate** — ``store_supported`` admits the all-ridge
    continuous-treatment DML and OrthoIV families, whose estimates are
    exact functionals of the stored moments.  Unsupported columns are
    fault-isolated: they land as failed ``ColumnResult``s with the
    gate's reason, never an exception.

Tracing: with ``tracer=`` (a ``repro_torch.obs.Tracer``) every ingest
runs in a ``store.ingest`` span and every refresh in a ``store.refresh``
span, each closing once the card has finished, and the tracer's metrics
count ``store.ingests``, ``store.ingest.rows``, ``store.refreshes`` and
gauge ``store.version``.

Data mesh (``data_mesh=``, a ``runtime.DataMesh``): every rank of the
mesh's group holds the store and ingests the same rows; each column's
ingest runs inside ``use_data_mesh``, so the rank reduces its own row
blocks of ``cfg.row_block`` rows and meets the other ranks in one
collective — under "pallas" one seg_gram launch a block.  "ordered"
mode seeds the fold of the blocks' partials with the standing
accumulators, the same left fold one pass over the concatenated rows
runs, so one-shot ≡ incremental stays bitwise on aligned ingests, and
the store is bitwise across rank counts.  On "chunked" it is bitwise
the store with no mesh.  On the card under "pallas" it is within
tolerance of it: with no mesh ``init`` seeds the kernel's own
accumulator, under a mesh it seeds the fold of per-block launches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import CausalConfig
from repro_torch.core.final_stage import cate_basis
from repro_torch.core.registry import EstimatorSpec, get_spec
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.inference.bootstrap import derive_seed
from repro_torch.kernels.seg_gram import ops as sg_ops
from repro_torch.obs.trace import maybe_span
from repro_torch.runtime.distributed import (DataMesh, check_data_mesh,
                                             first_rank_writes, use_data_mesh)
from repro_torch.store import stats as store_stats
from repro_torch.store.solve import refresh_column
from repro_torch.store.stats import ColumnLayout
from repro_torch.sweep.panel import ColumnResult, EffectPanel
from repro_torch.sweep.spec import SweepSpec

Tensor = torch.Tensor
_F32 = torch.float32


def store_supported(rspec: EstimatorSpec, cfg: CausalConfig
                    ) -> Tuple[bool, str]:
    """Gate: can this column be refreshed exactly from stored moments?

    Returns ``(ok, reason)``.  Admitted: the DML family and the OrthoIV
    family with all-ridge nuisances and continuous treatment — every
    statistic they need is a contraction of the store's Gram
    accumulators.  Excluded: logistic nuisances (per-iteration data
    passes), DRLearner/DRIV/metalearners (per-row pseudo-outcomes and
    clipped propensities are not Gram-additive).
    """
    if rspec.name.startswith("dml") or rspec.name.startswith("orthoiv"):
        iv = rspec.needs_instrument
        if cfg.discrete_treatment:
            return False, (f"store: {rspec.name} with discrete_treatment "
                           "needs a logistic propensity (per-iteration "
                           "data passes); use discrete_treatment=False "
                           "with nuisance_t='ridge'")
        for field, kind in (("nuisance_y", cfg.nuisance_y),
                            ("nuisance_t", cfg.nuisance_t)) + (
                                (("nuisance_z", cfg.nuisance_z),) if iv
                                else ()):
            if kind != "ridge":
                return False, (f"store: {rspec.name} requires "
                               f"{field}='ridge' (got {kind!r}) — only "
                               "ridge normal equations are exact "
                               "functionals of the stored Grams")
        return True, ""
    return False, (f"store: {rspec.name} builds per-row pseudo-outcomes/"
                   "propensities (not Gram-additive); supported families: "
                   "dml*, orthoiv* with all-ridge nuisances")


def _basis_width(p: int, n_features: int) -> int:
    """Width of ``cate_basis(X, n_features)`` for X with p columns."""
    return 1 if n_features <= 1 else 1 + min(n_features - 1, p)


@dataclasses.dataclass
class _Column:
    name: str
    cfg: CausalConfig
    rspec: EstimatorSpec
    layout: Optional[ColumnLayout]
    state: Optional[store_stats.State]
    error: Optional[str]
    aligned: bool = True  # per-column: no misaligned ingest yet


class MomentStore:
    """Per-(segment, fold) sufficient-statistics store over a SweepSpec.

    ``n_features`` fixes the X width up front so every accumulator (and
    the checkpoint template) exists before the first row arrives.
    ``seed`` roots the fold-assignment lineage (column i draws from
    ``derive_seed(seed, i)``, as the sweep's columns do).  ``data_mesh``
    row-shards every ingest (module docstring).  ``device``: where the
    accumulators live (None: the mesh's device, else the CUDA card).
    """

    def __init__(self, spec: SweepSpec, n_features: int, seed: int = 0, *,
                 tracer=None, data_mesh: Optional[DataMesh] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.tracer = tracer
        self.data_mesh = check_data_mesh(data_mesh)
        self.n_features = int(n_features)
        self.seed = int(seed)
        self.device = resolve_device(
            device if device is not None or data_mesh is None
            else data_mesh.device)
        self.n_total = 0
        self.n_ingests = 0
        self.version = 0
        self.seg_counts = torch.zeros((spec.n_segments,), dtype=_F32,
                                      device=self.device)
        self._cols: List[_Column] = []
        for name, cfg in spec.columns:
            rspec = get_spec(name)
            ok, reason = store_supported(rspec, cfg)
            if not ok:
                self._cols.append(_Column(name, cfg, rspec, None, None,
                                          reason))
                continue
            layout = ColumnLayout(
                p=self.n_features,
                pf=_basis_width(self.n_features, cfg.cate_features),
                k=cfg.n_folds, iv=rspec.needs_instrument)
            state = store_stats.init_state(
                layout, spec.n_segments * layout.k, device=self.device)
            self._cols.append(_Column(name, cfg, rspec, layout, state, None))

    # ------------------------------------------------------------------
    # Alignment regime (per column)
    # ------------------------------------------------------------------
    @property
    def column_aligned(self) -> Tuple[Optional[bool], ...]:
        """Per-column alignment: True = every ingest of that column
        ended on its ``row_block`` boundary (bitwise-ingest regime),
        False = tolerance regime, None = unsupported column."""
        return tuple(None if c.layout is None else c.aligned
                     for c in self._cols)

    @property
    def aligned(self) -> bool:
        """Store-wide rollup: every supported column still bitwise."""
        return all(c.aligned for c in self._cols if c.layout is not None)

    # ------------------------------------------------------------------
    # Fold lineage
    # ------------------------------------------------------------------
    def column_seed(self, col_index: int) -> int:
        """The fold-assignment seed of column ``col_index``."""
        return derive_seed(self.seed, col_index)

    def fold_assignment(self, col_index: int, start: int, n: int) -> Tensor:
        """Folds of global rows [start, start+n) for one column —
        index-keyed, so a row's fold never depends on later arrivals."""
        col = self._cols[col_index]
        if col.layout is None:
            raise ValueError(col.error)
        return _row_folds(self.column_seed(col_index), start, n,
                          col.layout.k)

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------
    def ingest(self, *, X, y, t, segment_ids, z=None) -> "MomentStore":
        """Fold a new row block into every supported column's cells.

        One pass per column over ONLY the new rows.  Empty blocks are
        exact no-ops on the accumulators (the version still advances).
        Returns ``self``.
        """
        dev = self.device
        X = as_f32(X, dev)
        if X.dim() != 2 or X.shape[1] != self.n_features:
            raise ValueError(f"store: X must be (n, {self.n_features}), "
                             f"got {tuple(X.shape)}")
        n = int(X.shape[0])
        needs_z = any(c.layout is not None and c.layout.iv
                      for c in self._cols)
        if needs_z and z is None:
            raise ValueError("store: spec has instrumented columns; "
                             "ingest requires z")
        with maybe_span(self.tracer, "store.ingest", cat="store", rows=n,
                        version=self.version + 1):
            if n:
                self._ingest_rows(X, y, t, z, segment_ids, n)
            self.version += 1
            self.n_ingests += 1
            if self.tracer is not None:
                self.tracer.sync(self.state_dict())
        if self.tracer is not None:
            m = self.tracer.metrics
            m.counter("store.ingests").inc()
            m.counter("store.ingest.rows").inc(n)
            m.gauge("store.version").set(self.version)
        return self

    def _ingest_rows(self, X, y, t, z, segment_ids, n: int) -> None:
        dev = self.device
        y, t = as_f32(y, dev), as_f32(t, dev)
        z = None if z is None else as_f32(z, dev)
        sids = torch.as_tensor(segment_ids, device=dev).long()
        for i, col in enumerate(self._cols):
            if col.layout is None:
                continue
            cfg, layout = col.cfg, col.layout
            rb = cfg.row_block
            if rb > 0 and self.n_total % rb != 0:
                # prior ingests broke THIS column's block alignment:
                # still correct, but its bitwise contract degrades to
                # tolerance from here on
                col.aligned = False
            folds = _row_folds(self.column_seed(i), self.n_total, n,
                               layout.k).to(dev)
            comb = sids * layout.k + folds
            phi = cate_basis(X, cfg.cate_features)
            with use_data_mesh(self.data_mesh):
                col.state = store_stats.ingest_cells(
                    layout, col.state, X, t, y, z if layout.iv else None,
                    phi, comb, self.spec.n_segments * layout.k,
                    row_block=cfg.row_block,
                    strategy=cfg.row_block_strategy)
        self.seg_counts = self.seg_counts + sg_ops.segment_counts(
            sids, self.spec.n_segments)
        self.n_total += n

    # ------------------------------------------------------------------
    # Refresh
    # ------------------------------------------------------------------
    def refresh(self) -> EffectPanel:
        """Re-solve every column from its accumulators (no data pass)
        and emit the refreshed ``EffectPanel``."""
        with maybe_span(self.tracer, "store.refresh", cat="store",
                        version=self.version, n_total=self.n_total):
            panel = self._refresh()
            if self.tracer is not None:
                self.tracer.sync(panel)
        if self.tracer is not None:
            self.tracer.metrics.counter("store.refreshes").inc()
        return panel

    def _refresh(self) -> EffectPanel:
        columns = []
        tag = (f"store:v{self.version}",)
        for i, col in enumerate(self._cols):
            if col.layout is None:
                columns.append(ColumnResult(estimator=col.name, cfg=col.cfg,
                                            key_index=i, error=col.error))
                continue
            out = refresh_column(col.layout, col.state,
                                 self.spec.n_segments,
                                 ridge_lambda=col.cfg.ridge_lambda)
            columns.append(ColumnResult(
                estimator=col.name, cfg=col.cfg, thetas=out["theta"],
                ates=out["ate"], ses=out["se"], key_index=i, events=tag,
                aligned=col.aligned))
        return EffectPanel(columns=tuple(columns), counts=self.seg_counts,
                           n_segments=self.spec.n_segments,
                           segment_key=self.spec.segment_key)

    # ------------------------------------------------------------------
    # Versioned snapshots (checkpoint/)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The checkpointable nested dict: segment counts + per-supported-
        column accumulators (keyed by column index)."""
        d: Dict[str, Any] = {"seg_counts": self.seg_counts}
        for i, col in enumerate(self._cols):
            if col.state is not None:
                d[f"col{i}"] = col.state
        return d

    def _meta(self) -> Dict[str, Any]:
        return {
            "n_total": self.n_total,
            "n_ingests": self.n_ingests,
            "aligned": self.aligned,
            "column_aligned": list(self.column_aligned),
            "n_features": self.n_features,
            "n_segments": self.spec.n_segments,
            "segment_key": self.spec.segment_key,
            "columns": [c.name for c in self._cols],
        }

    def save(self, manager, *, metric: Optional[float] = None) -> int:
        """Snapshot the store at its current version through a
        ``checkpoint.CheckpointManager`` (atomic tmp+rename; under a mesh
        rank 0 writes and the other ranks wait for it).  Returns the step
        (= version) written."""
        first_rank_writes(self.data_mesh, lambda: manager.save(
            self.version, self.state_dict(), metric=metric,
            extra=self._meta()))
        return self.version

    def restore(self, manager, *, step: Optional[int] = None
                ) -> "MomentStore":
        """Hot-swap/rollback: replace the accumulators with snapshot
        ``step`` (latest if None).  Spec provenance is checked so a
        checkpoint from a different column set fails loudly."""
        state, meta = manager.restore(self.state_dict(), step=step)
        extra = meta.get("extra", {})
        want = [c.name for c in self._cols]
        if extra.get("columns") != want:
            raise ValueError(
                f"store: checkpoint columns {extra.get('columns')} do not "
                f"match this spec's {want}")
        if extra.get("n_features") != self.n_features:
            raise ValueError(
                f"store: checkpoint n_features {extra.get('n_features')} "
                f"!= {self.n_features}")
        self.seg_counts = state["seg_counts"]
        for i, col in enumerate(self._cols):
            if col.state is not None:
                col.state = state[f"col{i}"]
        self.version = int(meta["step"])
        self.n_total = int(extra.get("n_total", 0))
        self.n_ingests = int(extra.get("n_ingests", 0))
        col_aligned = extra.get(
            "column_aligned",
            [bool(extra.get("aligned", True))] * len(self._cols))
        for col, flag in zip(self._cols, col_aligned):
            if col.layout is not None:
                col.aligned = bool(flag)
        return self


def _row_folds(col_seed: int, start: int, n: int, k: int) -> Tensor:
    """(n,) int64 folds of global rows [start, start+n): splitmix64 of
    (col_seed, row index) — ``bootstrap.derive_seed`` over a vector of
    indices, in wrapping uint64 arithmetic — mod k.  CPU tensor."""
    idx = np.arange(start, start + n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (np.uint64(col_seed) * np.uint64(0x9E3779B97F4A7C15)
             + (idx + np.uint64(1)) * np.uint64(0xBF58476D1CE4E5B9))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = (z ^ (z >> np.uint64(31))) >> np.uint64(1)
    return torch.from_numpy((z % np.uint64(k)).astype(np.int64))
