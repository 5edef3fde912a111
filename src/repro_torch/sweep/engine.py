"""The sweep engine: estimate E segments × C estimator-configs as
batched programs instead of a Python loop.

The port runs the reference's ``mode="segmented"``: every DML-family
column collapses onto ONE segment×fold-segmented pass over the data
(``sweep.segmented``, the segment-walking kernel on the card) — the
many-effects-cheaply execution.  A column that the one-pass kernels do
not cover, which the reference runs as masked weighted cells through
its task runtime, becomes a failed column naming ROADMAP A.9 (the
runtime slice); so do ``mode="cells"``, replicate CIs
(``with_ci=True``) and ``serial_loop``, at entry.  Data meshes wait for
A.10.

Tracing (``tracer=``, a ``repro_torch.obs.Tracer``): each column runs in
a ``sweep.column[<i>]`` span that closes once the card has finished it,
and the columns of one (estimator, nuisance signature) group nest in a
``sweep.group:<name>`` span when the group has more than one.  The
task runtime's chunk spans inside them land with A.9.

Fault isolation: a failing column (unknown estimator, missing
instrument, unsupported config, an error inside its fit) is recorded
on its ``ColumnResult.error``; every other column keeps its estimates.
Zero-row segments yield flagged (``ok = False``) finite cells.

Checkpoints (``checkpoint=``, a ``CheckpointManager``): each column
saves as step = column index the moment it settles, with a provenance
signature; a resumed sweep restores matching completed columns (tagged
"restored") and recomputes only missing or failed ones.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.registry import (EstimatorSpec, get_spec,
                                       nuisance_signature)
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.inference.bootstrap import derive_seed
from repro_torch.obs.trace import maybe_span
from repro_torch.sweep.panel import ColumnResult, EffectPanel
from repro_torch.sweep.segmented import segmented_column, segmented_supported
from repro_torch.sweep.spec import SweepSpec, segment_counts

Tensor = torch.Tensor

_RUNTIME = "ROADMAP A.9 (the task runtime)"


def column_keys(seed: int, col_index: int, n_segments: int) -> Tensor:
    """Per-cell fit seeds, (E,) int64: splitmix64 of (splitmix64(seed,
    column), segment) — any single cell can be replayed alone (the
    lineage the bootstrap's replicate seeds carry)."""
    ck = derive_seed(seed, col_index)
    return torch.tensor([derive_seed(ck, s) for s in range(n_segments)],
                        dtype=torch.int64)


def column_generator(seed: int, col_index: int) -> torch.Generator:
    """The CPU generator that draws column ``col_index``'s shared folds
    (a CPU generator: the card and the CPU see the same folds)."""
    return torch.Generator().manual_seed(derive_seed(seed, col_index))


# -- per-column checkpoints --------------------------------------------------

_CKPT_SCHEMA = "sweep-column-v1"
_CKPT_ARRAYS = ("thetas", "ates", "ses", "ci_lo", "ci_hi", "replicates")


def _column_signature(name: str, cfg: CausalConfig, n_segments: int) -> str:
    """Provenance key a resumed column must match: same estimator, same
    frozen config (repr is stable for the dataclass), same grid height."""
    return hashlib.sha1(
        f"{name}|{cfg!r}|{n_segments}".encode()).hexdigest()[:16]


def _save_column(mgr, idx: int, col: ColumnResult, n_segments: int) -> None:
    """One checkpoint step per column (step = column index): the present
    result tensors + provenance meta.  Failed columns save too (the
    attempt is on record) but never restore — a resume recomputes them."""
    state = {k: getattr(col, k) for k in _CKPT_ARRAYS
             if getattr(col, k) is not None}
    extra = {
        "schema": _CKPT_SCHEMA,
        "signature": _column_signature(col.estimator, col.cfg, n_segments),
        "estimator": col.estimator,
        "key_index": int(col.key_index),
        "shared_nuisance": bool(col.shared_nuisance),
        "events": list(col.events),
        "error": col.error,
        "aligned": col.aligned,
    }
    mgr.save(idx, state, extra=extra)


def _restore_column(mgr, idx: int, name: str, cfg: CausalConfig,
                    n_segments: int, device) -> Optional[ColumnResult]:
    """The saved ColumnResult for step ``idx``, or None when it is
    missing, provenance-mismatched, or errored."""
    if not mgr.has_step(idx):
        return None
    arrays, meta = mgr.load(step=idx)
    extra = meta.get("extra") or {}
    if extra.get("schema") != _CKPT_SCHEMA:
        return None
    if extra.get("signature") != _column_signature(name, cfg, n_segments):
        return None
    if extra.get("error"):
        return None
    kw = {k: torch.as_tensor(arrays[k]).to(device) for k in _CKPT_ARRAYS
          if k in arrays}
    return ColumnResult(
        estimator=name, cfg=cfg,
        key_index=int(extra.get("key_index", idx)),
        shared_nuisance=bool(extra.get("shared_nuisance", False)),
        events=tuple(extra.get("events") or ()) + ("restored",),
        aligned=extra.get("aligned"), **kw)


def _segmented_or_cells(rspec: EstimatorSpec, cfg: CausalConfig,
                        col_index: int, base_data, n_segments: int,
                        seed: int, tracer=None) -> ColumnResult:
    """mode="segmented" dispatch: the one-pass kernels where they apply;
    a column they do not cover would run as cells, which wait for the
    runtime slice."""
    if not segmented_supported(rspec, cfg):
        return ColumnResult(
            estimator=rspec.name, cfg=cfg, key_index=col_index,
            error=(f"{rspec.name} with this config is outside the segmented "
                   f"kernels; its masked cells need {_RUNTIME}"))
    with maybe_span(tracer, f"sweep.column[{col_index}]", cat="sweep",
                    estimator=rspec.name, segmented=True):
        out = segmented_column(cfg, base_data, n_segments,
                               column_generator(seed, col_index))
        if tracer is not None:
            tracer.sync(out)
    return ColumnResult(estimator=rspec.name, cfg=cfg, thetas=out["theta"],
                        ates=out["ate"], ses=out.get("se"),
                        key_index=col_index, events=("segmented",))


def sweep(spec: SweepSpec, *, X, y, t, segment_ids, z=None, seed: int = 0,
          mode: str = "cells", with_ci: Optional[bool] = None, tracer=None,
          data_mesh=None, checkpoint=None, resume: bool = True,
          column_callback=None, device: DeviceLike = None) -> EffectPanel:
    """Run the (segments × estimator-configs) grid.

    mode="segmented"  DML-family columns collapse onto the one-pass
                      segment×fold Gram kernels (sweep.segmented);
                      other columns fail naming ROADMAP A.9.
    mode="cells"      the reference's default (masked weighted cells
                      through the task runtime): raises, naming A.9.
    seed              roots the fold lineage: column i draws its shared
                      folds from ``column_generator(seed, i)``.
    with_ci           True (replicate CIs) raises, naming A.9; the
                      segmented path computes point estimates and
                      sandwich se.
    tracer            optional ``repro_torch.obs.Tracer``: column and
                      group spans (see the module docstring); None
                      records nothing.
    checkpoint        optional ``CheckpointManager``: each column saves
                      as step = column index the moment it settles
                      (success OR error); ``keep_latest`` is raised to
                      cover the grid.
    resume            with ``checkpoint``: restore provenance-matching
                      completed columns (tagged "restored") and
                      recompute only missing/failed ones.
    column_callback   ``f(index, ColumnResult)`` called as each column
                      settles (including restored ones).
    device            where the columns run (None: the CUDA card).
    """
    if mode not in ("cells", "segmented"):
        raise ValueError(f"unknown sweep mode {mode!r} (cells | segmented)")
    if mode == "cells":
        raise NotImplementedError(
            f"sweep mode 'cells' runs masked cells through {_RUNTIME}; "
            "the port runs mode='segmented'")
    if with_ci:
        raise NotImplementedError(f"replicate CIs per cell need {_RUNTIME}")
    if data_mesh is not None:
        raise NotImplementedError("data meshes land with the distributed "
                                  "slice (ROADMAP A.10)")
    dev = resolve_device(device)
    n_seg = spec.n_segments
    sids = torch.as_tensor(segment_ids, device=dev).long()
    base_data: Dict[str, Any] = {"X": as_f32(X, dev), "y": as_f32(y, dev),
                                 "t": as_f32(t, dev), "sids": sids}
    if z is not None:
        base_data["z"] = as_f32(z, dev)
    counts = segment_counts(sids, n_seg)

    results: Dict[int, ColumnResult] = {}
    if checkpoint is not None:
        # retention must cover one step per column or early columns
        # would be pruned before the sweep finishes
        checkpoint.keep_latest = max(checkpoint.keep_latest,
                                     len(spec.columns) + 1)

    def record(idx: int, col: ColumnResult, *, save: bool = True) -> None:
        results[idx] = col
        if save and checkpoint is not None:
            _save_column(checkpoint, idx, col, n_seg)
        if column_callback is not None:
            column_callback(idx, col)

    restored: set = set()
    if checkpoint is not None and resume:
        for idx, (name, cfg) in enumerate(spec.columns):
            col = _restore_column(checkpoint, idx, name, cfg, n_seg, dev)
            if col is not None:
                restored.add(idx)
                record(idx, col, save=False)

    # group columns by (estimator, nuisance signature), in spec order
    groups: Dict[Any, List[Tuple[int, CausalConfig]]] = {}
    for idx, (name, cfg) in enumerate(spec.columns):
        if idx not in restored:
            groups.setdefault((name, nuisance_signature(cfg)), []).append(
                (idx, cfg))

    for (name, _), members in groups.items():
        try:
            rspec = get_spec(name)
            if rspec.weighted_fit is None:
                raise ValueError(f"estimator {name!r} has no weighted fit")
            if rspec.needs_instrument and z is None:
                raise ValueError(f"estimator {name!r} needs an instrument z")
        except Exception as err:  # noqa: BLE001 — isolated per column
            for idx, cfg in members:
                record(idx, ColumnResult(estimator=name, cfg=cfg,
                                         key_index=idx, error=str(err)))
            continue
        group = tracer if len(members) > 1 else None
        with maybe_span(group, f"sweep.group:{name}", cat="sweep",
                        members=len(members), segments=n_seg):
            for idx, cfg in members:
                try:
                    col = _segmented_or_cells(rspec, cfg, idx, base_data,
                                              n_seg, seed, tracer)
                except Exception as err:  # noqa: BLE001
                    col = ColumnResult(estimator=name, cfg=cfg,
                                       key_index=idx, error=str(err))
                record(idx, col)

    columns = tuple(results[i] for i in range(len(spec.columns)))
    return EffectPanel(columns=columns, counts=counts, n_segments=n_seg,
                       segment_key=spec.segment_key)


def serial_loop(*_args, **_kwargs):
    """The reference's baseline loop of masked single fits per cell —
    cells mode's certification partner — waits for the runtime slice."""
    raise NotImplementedError(f"serial_loop runs masked cells: {_RUNTIME}")
