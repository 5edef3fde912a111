"""The sweep engine: estimate E segments × C estimator-configs as
batched programs instead of a Python loop.

Execution model
---------------
Each cell of the grid is a *masked weighted single fit* (the registry's
``weighted_fit``): the segment mask enters the estimator exactly where
bootstrap resampling weights do, so per-segment statistics stream
through the seg_gram kernel — no per-segment data copies.  Each cell
draws its own folds from its own seed (``column_keys``: the cell's fold
generator, ``cell_folds``).  The port's cells are the batch-invariant
closures the bootstrap's replicates run, so the panel is BITWISE a
Python loop of the same single fits (``serial_loop``), proved in torch.

Scheduling
----------
The cell axis ``{"key", "sid"}`` maps through the task runtime,
inheriting its chunking (``CausalConfig.sweep_chunk`` /
``runtime_chunk`` / the memory model against ``runtime_memory_budget``
— at 64 segments × 5 folds a column is 320 fold-weighted Grams, so the
budget is what keeps it on the card) and the per-chunk downgrade
ladder.  Replicate CIs add the bootstrap axis through
``runtime.map_product`` — (cell × replicate) flattened onto one
replicate axis, each pair drawing its weights and folds from its own
generator (``ci_draws``).

Cost sharing
------------
  * columns that differ only in final stage (same
    ``registry.nuisance_signature``) share one residual pass per
    segment (``spec.residual_fit`` / ``spec.final_fit``);
  * ``mode="segmented"`` (DML family) collapses the per-cell fold Grams
    into ONE segment×fold-segmented pass over the data
    (``sweep.segmented``, the segment-walking kernel on the card);
    columns outside it fall back to cells.

Tracing (``tracer=``, a ``repro_torch.obs.Tracer``): each column runs in
a ``sweep.column[<i>]`` span and a shared-nuisance group (or several
segmented columns of one estimator) in a ``sweep.group:<name>`` span,
with the runtime's map and chunk spans nested inside.

Fault isolation: a failing column (unknown estimator, missing
instrument, a config the port cannot build, or an error past the
downgrade ladder) is recorded on its ``ColumnResult.error``; every other
column keeps its estimates.
Zero-row segments yield flagged (``ok = False``) finite cells.

Data mesh (``data_mesh=``, a ``runtime.DataMesh``): every rank of the
mesh's group calls ``sweep`` with the same arguments.  The cells' runtime
takes the mesh (``TaskRuntime(data_mesh=)``), so each blocked moment of a
cell (``cfg.row_block > 0``) reduces the rank's own row blocks and meets
the other ranks in one collective — under "pallas" one seg_gram launch a
block — and a lost shard drops its chunk to the ladder on each rank
alone.  "ordered" panels are bitwise across rank counts, and bitwise the
panel with no mesh off the kernel ("chunked"); under "pallas" they are
within tolerance of it (per-block launches against one pass).  A column
on the shard_map executor splits its cells over the mesh's ranks
instead, each cell whole on one rank (bitwise the vmap column with no
mesh), and raises without a mesh.  The segmented fast path stays
single-host: the mesh reaches only its cells fallback.

Checkpoints (``checkpoint=``, a ``CheckpointManager``): each column
saves as step = column index the moment it settles, with a provenance
signature; a resumed sweep restores matching completed columns (tagged
"restored") and recomputes only missing or failed ones.  Under a mesh
with a group, rank 0 writes and the other ranks wait for it, and every
rank reads the same directory; the signature does not hold the rank
count, so columns saved on N ranks restore on M (``launch.elastic``).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import CausalConfig
from repro_torch.core.crossfit import fold_ids
from repro_torch.core.estimator import resolve_scheme
from repro_torch.core.final_stage import cate_basis
from repro_torch.core.registry import (EstimatorSpec, get_spec,
                                       nuisance_signature)
from repro_torch.device import DeviceLike, as_f32, resolve_device
from repro_torch.inference.bootstrap import bootstrap_weights, derive_seed
from repro_torch.inference.executor import make_executor
from repro_torch.obs.trace import maybe_span
from repro_torch.runtime import as_runtime
from repro_torch.runtime.distributed import (check_data_mesh,
                                             first_rank_writes)
from repro_torch.sweep.panel import ColumnResult, EffectPanel
from repro_torch.sweep.segmented import segmented_column, segmented_supported
from repro_torch.sweep.spec import SweepSpec, segment_counts

Tensor = torch.Tensor

_BOOT_SCHEMES = ("bootstrap", "multiplier", "bayesian")


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


def cell_folds(seed: int, n: int, k: int, device=None) -> Tensor:
    """(n,) folds of the cell whose seed is ``seed`` (``column_keys``),
    drawn on its own CPU generator."""
    return fold_ids(torch.Generator().manual_seed(int(seed)), n, k,
                    device=device)


def ci_draws(ci_seed: int, b: int, sid: int, n: int, k: int, scheme: str,
             device=None) -> Tuple[Tensor, Tensor]:
    """(folds (n,), weights (n,)) of replicate ``b`` of segment ``sid``'s
    CI: its weights, then its folds, from one CPU generator seeded from
    ``(ci_seed, b, sid)`` alone."""
    g = torch.Generator().manual_seed(derive_seed(derive_seed(ci_seed, b),
                                                  sid))
    w = bootstrap_weights(g, n, scheme)
    return fold_ids(g, n, k, device=device), w.to(device)


def _segment_mask(sids: Tensor, sid: Tensor) -> Tensor:
    """(c, n) fp32: 1 where row n is in segment sid[c]."""
    return (sids[None, :] == sid.to(sids.device)[:, None]).to(torch.float32)


def _runtime(cfg: CausalConfig, executor, tracer=None, data_mesh=None):
    """The column's TaskRuntime; "shard_map" raises without a mesh."""
    return as_runtime(
        executor if executor is not None else cfg.inference_executor,
        memory_budget=cfg.runtime_memory_budget,
        chunk=cfg.sweep_chunk or cfg.runtime_chunk,
        max_retries=cfg.runtime_max_retries, tracer=tracer,
        data_mesh=data_mesh)


def _make_masked_cell(cell, n_folds: int):
    def _masked_cell(xs, d):
        n, dev = d["sids"].shape[0], d["sids"].device
        folds = torch.stack([cell_folds(key, n, n_folds, dev)
                             for key in xs["key"].tolist()])
        return cell(folds, _segment_mask(d["sids"], xs["sid"]), d)

    return _masked_cell


def _make_masked_resid(resid_fn, n_folds: int):
    def _masked_resid(xs, d):
        n, dev = d["sids"].shape[0], d["sids"].device
        folds = torch.stack([cell_folds(key, n, n_folds, dev)
                             for key in xs["key"].tolist()])
        return resid_fn(folds, _segment_mask(d["sids"], xs["sid"]), d)

    return _masked_resid


def _make_masked_final(final_fn):
    def _masked_final(xs, d):
        return final_fn(xs["resid"], _segment_mask(d["sids"], xs["sid"]), d)

    return _masked_final


def _make_replicate_cell(cell, ci_seed: int, n_folds: int, scheme: str):
    def _rep_cell(xo, xi, d):
        # per-(cell, replicate) draws: replicate b of segment sid
        n, dev = d["sids"].shape[0], d["sids"].device
        draws = [ci_draws(ci_seed, b, sid, n, n_folds, scheme, dev)
                 for sid, b in zip(xo["sid"].tolist(), xi.tolist())]
        folds = torch.stack([f for f, _ in draws])
        w = _segment_mask(d["sids"], xo["sid"]) * torch.stack(
            [w for _, w in draws])
        out = cell(folds, w, d)
        return {"theta": out["theta"], "ate": out["ate"]}

    return _rep_cell


def _column_data(base_data: Dict[str, Any], cfg: CausalConfig
                 ) -> Dict[str, Any]:
    d = dict(base_data)
    d["phi"] = cate_basis(base_data["X"], cfg.cate_features)
    return d


def _cells(seed: int, col_index: int, n_segments: int) -> Dict[str, Tensor]:
    return {"key": column_keys(seed, col_index, n_segments),
            "sid": torch.arange(n_segments)}


def _column_ci(cell, cfg: CausalConfig, rt, xs, data, seed: int,
               col_index: int) -> Dict[str, Any]:
    """(cell × replicate) bootstrap draws through map_product: the two
    parallel axes flatten onto one replicate axis, chunked and
    downgraded by the scheduler like any other replicate program."""
    # non-resampling methods (jackknife) have no per-cell replicate
    # program; they substitute the pairs bootstrap, and the column's
    # events carry a "ci:<scheme>" tag so the substitution is visible
    method = cfg.inference if cfg.inference in _BOOT_SCHEMES else "bootstrap"
    scheme = resolve_scheme(method)
    ci_seed = derive_seed(derive_seed(seed, col_index), 0x0B00)
    rep_cell = _make_replicate_cell(cell, ci_seed, cfg.n_folds, scheme)
    draws = rt.map_product(rep_cell, xs, torch.arange(cfg.n_bootstrap),
                           data, label="sweep:ci")
    a = cfg.alpha
    return dict(ci_lo=torch.quantile(draws["ate"], a / 2.0, dim=1),
                ci_hi=torch.quantile(draws["ate"], 1.0 - a / 2.0, dim=1),
                replicates=draws["theta"], ci_scheme=scheme)


def _events(rt, start_total: int = 0) -> Tuple[str, ...]:
    # EventLog.since is drop-safe: start_total is an events.total
    # checkpoint, valid even if the ring dropped older entries
    return tuple(f"{e.action}:{e.backend}"
                 for e in rt.events.since(start_total))


def _want_ci(cfg: CausalConfig, with_ci: Optional[bool]) -> bool:
    if with_ci is not None:
        return bool(with_ci) and cfg.n_bootstrap > 0
    return cfg.inference not in ("none", "") and cfg.n_bootstrap > 0


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


def _ci_fields(extra: Dict[str, Any]) -> Dict[str, Any]:
    return {k: extra.get(k) for k in ("ci_lo", "ci_hi", "replicates")}


def _ci_tag(extra: Dict[str, Any]) -> Tuple[str, ...]:
    return (f"ci:{extra['ci_scheme']}",) if "ci_scheme" in extra else ()


def _run_column(rspec: EstimatorSpec, cfg: CausalConfig, col_index: int,
                base_data, n_segments: int, seed: int, executor,
                with_ci: Optional[bool], tracer=None,
                data_mesh=None) -> ColumnResult:
    """One column as E masked single-fit cells through the runtime."""
    cell = rspec.weighted_fit(cfg)
    data = _column_data(base_data, cfg)
    xs = _cells(seed, col_index, n_segments)
    rt = _runtime(cfg, executor, tracer, data_mesh)
    with maybe_span(rt.tracer, f"sweep.column[{col_index}]", cat="sweep",
                    estimator=rspec.name, segments=n_segments):
        out = rt.map(_make_masked_cell(cell, cfg.n_folds), xs, data,
                     label=f"sweep:{rspec.name}")
        extra: Dict[str, Any] = {}
        if _want_ci(cfg, with_ci):
            extra = _column_ci(cell, cfg, rt, xs, data, seed, col_index)
        if rt.tracer is not None:
            rt.tracer.sync(out)
    return ColumnResult(estimator=rspec.name, cfg=cfg, thetas=out["theta"],
                        ates=out["ate"], ses=out.get("se"),
                        key_index=col_index,
                        events=_events(rt) + _ci_tag(extra),
                        **_ci_fields(extra))


def _run_shared_group(rspec: EstimatorSpec,
                      members: List[Tuple[int, CausalConfig]], base_data,
                      n_segments: int, seed: int, executor,
                      with_ci: Optional[bool], tracer=None, data_mesh=None
                      ) -> List[Tuple[int, ColumnResult]]:
    """Columns differing only in final stage: ONE residual pass per
    segment (on the first member's cell seeds), then a cheap final-stage
    map per column."""
    first_idx, cfg0 = members[0]
    xs = _cells(seed, first_idx, n_segments)
    rt = _runtime(cfg0, executor, tracer, data_mesh)
    # the shared residual pass is group-fatal by design (every member
    # consumes it); everything after is isolated per member
    with maybe_span(rt.tracer, f"sweep.group:{rspec.name}", cat="sweep",
                    members=len(members), segments=n_segments):
        resids = rt.map(_make_masked_resid(rspec.residual_fit(cfg0),
                                           cfg0.n_folds),
                        xs, dict(base_data),
                        label=f"sweep:{rspec.name}:resid")
        results = []
        for col_index, cfg in members:
            ev_start = rt.events.total
            try:
                col = _shared_member_column(
                    rspec, cfg, first_idx, col_index, base_data, resids, xs,
                    rt, seed, with_ci, ev_start)
            except Exception as err:  # noqa: BLE001 — one member must not
                # discard its siblings' already-computed columns
                col = ColumnResult(estimator=rspec.name, cfg=cfg,
                                   key_index=first_idx,
                                   shared_nuisance=col_index != first_idx,
                                   error=str(err))
            results.append((col_index, col))
    return results


def _shared_member_column(rspec: EstimatorSpec, cfg: CausalConfig,
                          first_idx: int, col_index: int, base_data, resids,
                          xs, rt, seed: int, with_ci: Optional[bool],
                          ev_start: int) -> ColumnResult:
    data = _column_data(base_data, cfg)
    with maybe_span(rt.tracer, f"sweep.column[{col_index}]", cat="sweep",
                    estimator=rspec.name,
                    shared_nuisance=col_index != first_idx):
        out = rt.map(_make_masked_final(rspec.final_fit(cfg)),
                     {"sid": xs["sid"], "resid": resids}, data,
                     label=f"sweep:{rspec.name}:final")
        extra: Dict[str, Any] = {}
        if _want_ci(cfg, with_ci):
            # replicate refits reweight the nuisances, so CIs cannot
            # reuse the shared residuals — they run the full cell
            extra = _column_ci(rspec.weighted_fit(cfg), cfg, rt, xs, data,
                               seed, first_idx)
        if rt.tracer is not None:
            rt.tracer.sync(out)
    return ColumnResult(estimator=rspec.name, cfg=cfg, thetas=out["theta"],
                        ates=out["ate"], ses=out.get("se"),
                        key_index=first_idx,
                        shared_nuisance=col_index != first_idx,
                        events=_events(rt, ev_start) + _ci_tag(extra),
                        **_ci_fields(extra))


def _segmented_or_cells(rspec: EstimatorSpec, cfg: CausalConfig,
                        col_index: int, base_data, n_segments: int,
                        seed: int, executor, with_ci: Optional[bool],
                        tracer=None, data_mesh=None) -> ColumnResult:
    """mode="segmented" dispatch: the one-pass kernels where they apply,
    the cells path otherwise.  The one-pass path stays single-host; the
    mesh reaches only the cells fallback."""
    if not segmented_supported(rspec, cfg):
        return _run_column(rspec, cfg, col_index, base_data, n_segments,
                           seed, executor, with_ci, tracer, data_mesh)
    with maybe_span(tracer, f"sweep.column[{col_index}]", cat="sweep",
                    estimator=rspec.name, segmented=True):
        out = segmented_column(cfg, base_data, n_segments,
                               column_generator(seed, col_index))
        if tracer is not None:
            tracer.sync(out)
    return ColumnResult(estimator=rspec.name, cfg=cfg, thetas=out["theta"],
                        ates=out["ate"], ses=out.get("se"),
                        key_index=col_index, events=("segmented",))


def _base_data(X, y, t, segment_ids, z, dev) -> Dict[str, Any]:
    d: Dict[str, Any] = {"X": as_f32(X, dev), "y": as_f32(y, dev),
                         "t": as_f32(t, dev),
                         "sids": torch.as_tensor(segment_ids,
                                                 device=dev).long()}
    if z is not None:
        d["z"] = as_f32(z, dev)
    return d


def sweep(spec: SweepSpec, *, X, y, t, segment_ids, z=None, seed: int = 0,
          executor=None, mode: str = "cells", reuse: bool = True,
          with_ci: Optional[bool] = None, tracer=None, data_mesh=None,
          checkpoint=None, resume: bool = True, column_callback=None,
          device: DeviceLike = None) -> EffectPanel:
    """Run the (segments × estimator-configs) grid.

    mode="cells"      every cell is a masked weighted single fit through
                      the task runtime — bitwise ``serial_loop`` (the
                      default, as in the reference).
    mode="segmented"  DML-family columns collapse onto the one-pass
                      segment×fold Gram kernels (sweep.segmented);
                      other columns fall back to cells.
    seed              roots the lineage: column i's cells draw their
                      folds from ``column_keys(seed, i, E)`` (cells), or
                      its shared folds from ``column_generator(seed, i)``
                      (segmented).
    executor          the cells' backend (None: cfg.inference_executor),
                      a name, Executor or TaskRuntime.
    reuse=True        columns sharing a nuisance signature share one
                      residual pass (cells mode).
    with_ci           None = per column from cfg.inference; True/False
                      forces replicate CIs on/off.  CIs are resampling
                      draws: a non-resampling cfg.inference (jackknife)
                      substitutes the pairs bootstrap, tagged
                      "ci:pairs" in the column's events.
    tracer            optional ``repro_torch.obs.Tracer``: column and
                      group spans with the runtime's spans inside (see
                      the module docstring); None records nothing.
    data_mesh         optional ``runtime.DataMesh``: every rank calls
                      ``sweep`` alike and the cells' blocked moments
                      row-shard over the ranks (module docstring); a
                      shard_map column splits its cells over them.
                      The segmented fast path stays single-host.
    checkpoint        optional ``CheckpointManager``: each column saves
                      as step = column index the moment it settles
                      (success OR error; under a mesh rank 0 writes);
                      ``keep_latest`` is raised to cover the grid.
    resume            with ``checkpoint``: restore provenance-matching
                      completed columns (tagged "restored") and
                      recompute only missing/failed ones.
    column_callback   ``f(index, ColumnResult)`` called as each column
                      settles (including restored ones) — the event
                      stream hook of ``runtime.jobs``.
    device            where the columns run (None: the mesh's device,
                      else the CUDA card).
    """
    if mode not in ("cells", "segmented"):
        raise ValueError(f"unknown sweep mode {mode!r} (cells | segmented)")
    check_data_mesh(data_mesh)
    dev = resolve_device(device if device is not None or data_mesh is None
                         else data_mesh.device)
    n_seg = spec.n_segments
    base_data = _base_data(X, y, t, segment_ids, z, dev)
    counts = segment_counts(base_data["sids"], n_seg)

    results: Dict[int, ColumnResult] = {}
    if checkpoint is not None:
        # retention must cover one step per column or early columns
        # would be pruned before the sweep finishes
        checkpoint.keep_latest = max(checkpoint.keep_latest,
                                     len(spec.columns) + 1)

    def record(idx: int, col: ColumnResult, *, save: bool = True) -> None:
        results[idx] = col
        if save and checkpoint is not None:
            # one writer a directory; the other ranks wait for it
            first_rank_writes(data_mesh, lambda: _save_column(
                checkpoint, idx, col, n_seg))
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

        if mode == "segmented":
            group = tracer if len(members) > 1 else None
            with maybe_span(group, f"sweep.group:{name}", cat="sweep",
                            members=len(members), segments=n_seg):
                for idx, cfg in members:
                    try:
                        col = _segmented_or_cells(
                            rspec, cfg, idx, base_data, n_seg, seed,
                            executor, with_ci, tracer, data_mesh)
                    except Exception as err:  # noqa: BLE001
                        col = ColumnResult(estimator=name, cfg=cfg,
                                           key_index=idx, error=str(err))
                    record(idx, col)
            continue

        shareable = (reuse and len(members) > 1
                     and rspec.residual_fit is not None
                     and rspec.final_fit is not None)
        try:
            if shareable:
                for idx, col in _run_shared_group(
                        rspec, members, base_data, n_seg, seed, executor,
                        with_ci, tracer, data_mesh):
                    record(idx, col)
            else:
                for idx, cfg in members:
                    try:
                        col = _run_column(rspec, cfg, idx, base_data, n_seg,
                                          seed, executor, with_ci, tracer,
                                          data_mesh)
                    except Exception as err:  # noqa: BLE001
                        col = ColumnResult(estimator=name, cfg=cfg,
                                           key_index=idx, error=str(err))
                    record(idx, col)
        except Exception as err:  # noqa: BLE001 — one group must not
            # poison the panel; the runtime ladder already retried
            for idx, cfg in members:
                if idx not in results:
                    record(idx, ColumnResult(estimator=name, cfg=cfg,
                                             key_index=idx, error=str(err)))

    columns = tuple(results[i] for i in range(len(spec.columns)))
    return EffectPanel(columns=columns, counts=counts, n_segments=n_seg,
                       segment_key=spec.segment_key)


def serial_loop(estimator: str, cfg: CausalConfig, *, X, y, t, segment_ids,
                n_segments: int, z=None, seed: int = 0, col_index: int = 0,
                device: DeviceLike = None) -> Dict[str, Tensor]:
    """The baseline: a Python loop of masked single-estimator fits, one
    cell at a time through the ``serial`` executor, with exactly the
    cell seeds ``sweep()`` gives column ``col_index`` — cells mode is
    bitwise this loop (the cells are batch-invariant)."""
    dev = resolve_device(device)
    cell = get_spec(estimator).weighted_fit(cfg)
    data = _column_data(_base_data(X, y, t, segment_ids, z, dev), cfg)
    return make_executor("serial").map(_make_masked_cell(cell, cfg.n_folds),
                                       _cells(seed, col_index, n_segments),
                                       data)
