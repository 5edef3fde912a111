"""The task scheduler: Ray's pool semantics over the port's executors.

``TaskRuntime`` grows the flat ``Executor.map`` into the scheduling
layer the paper attributes to Ray:

  chunked scheduling   the replicate axis is split into chunks — an
                       explicit ``chunk``, or the largest chunk whose
                       peak the affine memory model (runtime.memory)
                       predicts under ``memory_budget``;
  fault tolerance      each chunk retries down the backend ladder
                       (shard_map → vmap → serial, on the same card with
                       the same kernels) on failure, the stand-in for Ray
                       re-executing a lost task on another worker.
                       Results stay bitwise: the port's replicate
                       functions are batch-invariant, so a downgraded
                       chunk computes the same bits;
  data mesh            with ``data_mesh=``, a chunk first runs on the
                       primary executor inside ``use_data_mesh`` (its
                       blocked moments row-sharded over the mesh's
                       ranks, runtime.distributed); a lost shard drops
                       that chunk to the ladder on this rank alone,
                       inside the mesh's one-rank twin: the same blocks
                       folded in the same order with no collective, so
                       the same bits for every strategy ("ordered").
                       A chunk the memory model sizes is the least
                       over the ranks (each probes its own peak);
  deterministic order  chunks are dispatched and concatenated in fixed
                       replicate order, whatever backends ran them;
  nested parallelism   ``map_product`` flattens two parallel axes
                       (cell × replicate) onto ONE replicate axis, which
                       the same chunked, fault-tolerant machinery
                       subdivides;
  futures              ``submit``/``call``/``gather`` (runtime.future)
                       express dependent stages — refuter panels — as a
                       task DAG.

A ``TaskRuntime`` with no budget, no explicit chunk, and a healthy
backend degenerates to exactly one ``Executor.map`` call, so migrating
callers onto the runtime costs nothing on the happy path.

Differences from the reference's scheduler:

  * the shard_map executor takes its mesh from ``data_mesh=`` or the
    active mesh and raises without one, where the reference spans the
    process's devices;
  * the reference's ``jit_cache_miss[...]`` counters have no
    counterpart: eager PyTorch compiles no per-closure program, so there
    is no miss to count (the kernels are built once per process);
  * a zero-length replicate axis is evaluated for its shapes alone on
    torch's ``meta`` device (tensors without data): a kernel wrapper
    launches only on CUDA tensors and refuses meta ones, so no kernel
    ever launches with B = 0; a closure that reads values (a generator
    draw from an id) cannot be evaluated so, and raises;
  * a CUDA error that leaves the context unusable (an illegal address, a
    device-side assert) surfaces as itself instead of walking the
    ladder: every later launch would fail with it too.

``EVENT_COUNTS`` counts every runtime's events by action in this
process, for a caller that gates on them (retries and downgrades of a
run); ``EventLog`` keeps each runtime's own tail.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.inference.executor import (Executor, concat_trees,
                                            leading_dim, make_executor,
                                            slice_tree, tree_leaves,
                                            tree_map)
from repro_torch.obs.audit import ChunkAudit
from repro_torch.obs.trace import Tracer, maybe_span
from repro_torch.runtime.distributed import (DataMesh, agree_min,
                                             check_data_mesh, use_data_mesh)
from repro_torch.runtime.future import TaskFuture, TaskGraph, resolve
from repro_torch.runtime.memory import (ChunkCost, MemoryModel,
                                        cached_model, input_device,
                                        memory_model, probe_chunk_cost)

# The fault-tolerance ladder: each backend's failure falls back to the
# next-simpler one.  serial has no fallback — its failure is the task's.
DOWNGRADE: dict = {"shard_map": "vmap", "vmap": "serial", "serial": None}

# every runtime's events by action, in this process
EVENT_COUNTS: collections.Counter = collections.Counter()

# CUDA errors after which the context is unusable
_STICKY = ("illegal memory access", "device-side assert",
           "unspecified launch failure", "misaligned address",
           "illegal instruction", "hardware stack error")


def poisons_context(err: BaseException) -> bool:
    """Whether ``err`` is a CUDA error that leaves the context unusable."""
    msg = str(err)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return "out of memory" not in msg
    return any(s in msg for s in _STICKY)


@dataclasses.dataclass(frozen=True)
class RuntimeEvent:
    """One scheduling decision or recovery, for tests and reports."""

    action: str  # "chunk" | "retry" | "downgrade" (jobs: "column", ...)
    label: str
    chunk_index: int = -1
    backend: str = ""
    detail: str = ""


class EventLog:
    """Bounded RuntimeEvent record: list-like for readers, ring-buffered
    so a long-lived runtime cannot grow an unbounded host-side list.
    ``total`` counts every event ever appended; ``since(start_total)``
    recovers a suffix recorded from a ``total`` checkpoint even after
    older entries were dropped."""

    def __init__(self, maxlen: int = 512):
        self._buf: "collections.deque[RuntimeEvent]" = collections.deque(
            maxlen=maxlen)
        self._total = 0

    def append(self, event: RuntimeEvent) -> None:
        self._buf.append(event)
        self._total += 1

    @property
    def total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return self._total - len(self._buf)

    def since(self, start_total: int) -> Tuple[RuntimeEvent, ...]:
        """Events appended at or after the ``total`` checkpoint
        ``start_total`` that are still buffered."""
        skip = max(0, start_total - self.dropped)
        return tuple(self._buf)[skip:]

    def clear(self) -> None:
        self._buf.clear()
        self._total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[RuntimeEvent]:
        return iter(tuple(self._buf))

    def __getitem__(self, ix):
        return tuple(self._buf)[ix]


def _meta(x: Any) -> Any:
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _empty_like_mapped(fn, xs: Any, args: Tuple[Any, ...]) -> Any:
    """Zero-replicate output: ``fn`` on the zero-length inputs moved to
    the meta device (shapes and dtypes only, no launch), materialized
    as empty tensors on the inputs' device."""
    dev = next(x.device for x in tree_leaves(xs)
               if isinstance(x, torch.Tensor))
    out = fn(tree_map(_meta, xs), *tree_map(_meta, args))
    return tree_map(lambda y: torch.zeros(y.shape, dtype=y.dtype,
                                          device=dev), out)


@dataclasses.dataclass
class _Chunk:
    """One executed chunk: its output, size, index, measured cost and
    seconds (None untraced)."""

    out: Any
    size: int
    index: int
    cost: Optional[ChunkCost] = None
    seconds: Optional[float] = None


class TaskRuntime:
    """Memory-aware, fault-tolerant scheduler over the port's executors.

    Parameters
    ----------
    executor       backend name (serial | vmap) or Executor instance —
                   the *preferred* backend; failures walk the DOWNGRADE
                   ladder from there.
    memory_budget  bytes the chunk may peak at above what is allocated
                   before it; 0 disables the memory model (one chunk).
    chunk          explicit replicate chunk size; 0 defers to the
                   memory model (CausalConfig.runtime_chunk).
    max_retries    extra attempts a chunk gets after its first failure
                   (each attempt moves one rung down the ladder).
    data_mesh      optional ``runtime.distributed.DataMesh``: each chunk
                   first runs on the primary executor with the mesh
                   active (the rung ``data_mesh[<label>]:<executor>``),
                   then down the ladder inside the mesh's one-rank
                   twin; a shard_map executor instead splits its
                   replicates over this mesh, each replicate whole on
                   one rank, and its ladder runs without the mesh.
    tracer         optional repro_torch.obs.Tracer: spans around map /
                   chunk / DAG-node execution (synchronized with the
                   card), chunk latency histograms, downgrade / retry
                   counters, chunk-size and predicted-peak gauges, and a
                   ``ChunkAudit`` row per chunk of a map the memory model
                   sized (its measured peak the allocator's).  None (the
                   default) records nothing; the same kernels run
                   either way.
    probe          ``probe(run, chunk) -> (out, peak bytes or None)``:
                   how a chunk's peak is measured.  None: the CUDA
                   allocator's peak on the inputs' card, and no model
                   when the inputs are not on a card.
    events_maxlen  ring-buffer capacity of the always-on RuntimeEvent
                   tail (EventLog; the tracer is the unbounded record).
    """

    # fn -> fused (outer, inner) wrapper, weak so dead closures drop out
    # (the memory model's cache keys on the closure object, so the
    # wrapper must be stable per fn)
    _PRODUCT_FNS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def __init__(self, executor="vmap", *, memory_budget: int = 0,
                 chunk: int = 0, max_retries: int = 2, data_mesh=None,
                 tracer: Optional[Tracer] = None,
                 probe: Optional[Callable] = None,
                 events_maxlen: int = 512):
        self.data_mesh = check_data_mesh(data_mesh)
        self._primary = make_executor(executor, mesh=data_mesh)
        # fn -> its closure inside the mesh / inside the one-rank twin
        self._mesh_fns: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._local_fns: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self.memory_budget = int(memory_budget)
        self.chunk = int(chunk)
        self.max_retries = int(max_retries)
        self.tracer = tracer
        self.probe = probe
        self.events = EventLog(maxlen=events_maxlen)
        self._graph = TaskGraph()

    def _emit(self, event: RuntimeEvent) -> None:
        """Record one scheduling decision: into the bounded EventLog and
        the process counts; when tracing, also as an instant marker and
        a counter."""
        self.events.append(event)
        EVENT_COUNTS[event.action] += 1
        tr = self.tracer
        if tr is not None:
            tr.instant(f"runtime.event.{event.action}", cat="runtime",
                       label=event.label, chunk_index=event.chunk_index,
                       backend=event.backend, detail=event.detail)
            tr.metrics.counter(f"runtime.events.{event.action}").inc()

    # -- identity -------------------------------------------------------
    @property
    def name(self) -> str:
        return self._primary.name

    # -- backend ladder -------------------------------------------------
    def _ladder(self) -> Tuple[Executor, ...]:
        chain: List[Executor] = [self._primary]
        nxt = DOWNGRADE.get(self._primary.name, "vmap")
        while nxt is not None:
            chain.append(make_executor(nxt))
            nxt = DOWNGRADE.get(nxt)
        seen, out = set(), []
        for exe in chain:
            if exe.name not in seen:
                seen.add(exe.name)
                out.append(exe)
        return tuple(out)

    def _on_mesh(self, fn, local: bool):
        """A stable per-(runtime, fn) closure that runs ``fn`` with the
        data mesh active — or, ``local``, its one-rank twin: the same
        row blocks and fold on this rank alone, no collective."""
        cache = self._local_fns if local else self._mesh_fns
        wrapped = cache.get(fn)
        if wrapped is None:
            dm = self.data_mesh
            if local:
                dm = dataclasses.replace(dm, group=None, rank=0, n_hosts=1,
                                         n_devices=1, backend=None)
            # a weak reference: a strong capture would pin the key alive
            # through its own value
            fn_ref = weakref.ref(fn)

            def wrapped(*a, **kw):
                with use_data_mesh(dm):
                    return fn_ref()(*a, **kw)

            cache[fn] = wrapped
        return wrapped

    def _attempt(self, exe: Executor, fn, xs_c: Any, args: Tuple[Any, ...],
                 label: str, index: int, measure: bool) -> _Chunk:
        size = leading_dim(xs_c)

        def run():
            return exe.map(fn, xs_c, *args)

        tr = self.tracer
        if tr is None and not measure:
            return _Chunk(run(), size, index)
        with maybe_span(tr, "runtime.chunk", cat="runtime", label=label,
                        chunk_index=index, chunk_size=size,
                        backend=exe.name) as sp:
            out, cost = (probe_chunk_cost(run, size,
                                          input_device(xs_c, args),
                                          self.probe) if measure
                         else (run(), None))
            if tr is not None:
                tr.sync(out)
        if tr is None:
            return _Chunk(out, size, index, cost)
        tr.metrics.counter("runtime.chunks").inc()
        tr.metrics.histogram("runtime.chunk_seconds").observe(sp.duration_s)
        return _Chunk(out, size, index, cost, sp.duration_s)

    def _run_chunk(self, fn, xs_c: Any, args: Tuple[Any, ...], label: str,
                   index: int, measure: bool = False) -> _Chunk:
        err: Optional[BaseException] = None
        # the attempt plan: the data-mesh rung on the primary executor
        # first, then the backend ladder — under a mesh, on this rank
        # alone inside its one-rank twin (the same bits)
        plans: List[Tuple[Executor, Any, str]] = []
        rung_fn = fn
        # a shard_map primary splits the replicates over the mesh instead:
        # each replicate runs whole on one rank, with no mesh, on every
        # rung (ShardMapExecutor)
        if self.data_mesh is not None and self._primary.name != "shard_map":
            plans.append((self._primary, self._on_mesh(fn, local=False),
                          f"data_mesh[{self.data_mesh.label}]:"
                          f"{self._primary.name}"))
            rung_fn = self._on_mesh(fn, local=True)
        plans.extend((exe, rung_fn, exe.name) for exe in self._ladder())
        for attempt, (exe, run_fn, rung) in enumerate(plans):
            if attempt > self.max_retries:
                break
            if attempt:
                self._emit(RuntimeEvent("downgrade", label, index, rung,
                                        str(err)))
            try:
                ch = self._attempt(exe, run_fn, xs_c, args, label, index,
                                   measure)
            except Exception as e:  # noqa: BLE001 — the ladder handles it
                if poisons_context(e):
                    raise
                err = e
                # a re-attempt is coming iff the ladder has a lower rung
                # left AND the retry budget allows it
                if attempt < self.max_retries and attempt + 1 < len(plans):
                    self._emit(RuntimeEvent("retry", label, index, rung,
                                            str(e)))
                continue
            # a failed attempt's traceback holds this frame, and with it
            # the chunk's tensors, in a cycle: drop it
            err = None
            return ch
        assert err is not None
        raise err

    # -- chunk sizing ---------------------------------------------------
    def _plan(self, fn, xs: Any, args: Tuple[Any, ...], b: int, label: str
              ) -> Tuple[int, Optional[MemoryModel], List[_Chunk]]:
        """(chunk, model, the probe chunks already run, in order)."""
        if self.chunk:
            return max(1, min(self.chunk, b)), None, []
        if self.memory_budget <= 0 or b <= 1:
            return b, None, []
        found, model = cached_model(fn, xs, args)
        if not found and self.probe is None and input_device(xs, args) is None:
            return b, None, []
        done: List[_Chunk] = []

        def probe(c: int) -> Optional[float]:
            lo = sum(ch.size for ch in done)
            ch = self._run_chunk(fn, slice_tree(xs, lo, lo + c), args, label,
                                 len(done), measure=True)
            done.append(ch)
            return ch.cost.peak_bytes

        model = memory_model(fn, xs, args, b, probe)
        if model is None:
            return b, None, done
        # each rank reads its own peaks; the ranks of a mesh map with the
        # least chunk, so their chunks meet in the same collectives
        return (agree_min(self.data_mesh,
                          model.max_chunk(self.memory_budget, b)),
                model, done)

    def plan_chunk(self, fn, xs: Any, args: Tuple[Any, ...], b: int
                   ) -> Tuple[int, Optional[MemoryModel]]:
        """(chunk size, memory model) the scheduler would use for this
        map.  On the card an unprobed closure is probed here, which runs
        its probe chunks (their outputs are dropped; ``map`` keeps
        them)."""
        chunk, model, _ = self._plan(fn, xs, args, b, "plan")
        return chunk, model

    # -- the map primitive ----------------------------------------------
    def map(self, fn: Callable[..., Any], xs: Any, *args: Any,
            label: str = "") -> Any:
        """Map ``fn`` over the leading replicate axis of ``xs`` with
        chunked, fault-tolerant scheduling.  Results are ordered by
        replicate index regardless of chunking or downgrades."""
        b = leading_dim(xs)
        if b == 0:
            return _empty_like_mapped(fn, xs, args)
        tr = self.tracer
        with maybe_span(tr, "runtime.map", cat="runtime", label=label, b=b,
                        backend=self._primary.name) as sp:
            chunk, model, done = self._plan(fn, xs, args, b, label)
            if sp is not None:
                sp.attrs["chunk"] = chunk
            if tr is not None and model is not None:
                tag = f"[{label}]" if label else ""
                tr.metrics.gauge(f"runtime.chunk_size{tag}").set(chunk)
                tr.metrics.gauge(f"runtime.predicted_peak_bytes{tag}").set(
                    model.peak(chunk))
            lo = sum(ch.size for ch in done)
            if not done and chunk >= b:
                return self._run_chunk(fn, xs, args, label, 0).out
            self._emit(RuntimeEvent("chunk", label, -1, self._primary.name,
                                    f"b={b} chunk={chunk}"))
            measure = tr is not None and model is not None
            for hi in range(lo + chunk, b + chunk, chunk):
                done.append(self._run_chunk(
                    fn, slice_tree(xs, lo, min(hi, b)), args, label,
                    len(done), measure=measure))
                lo = hi
            if measure:
                for ch in done:
                    self._audit(label, ch, model)
            return concat_trees([ch.out for ch in done])

    def _audit(self, label: str, ch: _Chunk, model: MemoryModel) -> None:
        if ch.cost is None or ch.cost.peak_bytes is None:
            return
        self.tracer.audit.record(ChunkAudit(
            label=label, chunk_index=ch.index, chunk_size=ch.size,
            predicted_peak_bytes=model.peak(ch.size),
            probed_peak_bytes=ch.cost.peak_bytes, flops=ch.cost.flops,
            hbm_bytes=ch.cost.hbm_bytes, measured_s=ch.seconds))

    # -- nested parallelism ---------------------------------------------
    def map_product(self, fn: Callable[..., Any], xs_outer: Any,
                    xs_inner: Any, *args: Any, label: str = "") -> Any:
        """One replicate axis for two parallel axes: ``fn(xo, xi, *args)``
        over the (b_outer × b_inner) product, outer-major, so chunking
        and fault tolerance subdivide the *product*; reshaped back to
        (b_outer, b_inner, ...)."""
        bo = leading_dim(xs_outer)
        bi = leading_dim(xs_inner)
        fused = TaskRuntime._PRODUCT_FNS.get(fn)
        if fused is None:
            # the wrapper holds only a weakref to fn: a strong capture
            # would pin the WeakKeyDictionary key alive through its own
            # value
            fn_ref = weakref.ref(fn)

            def fused(pair, *a):
                return fn_ref()(pair["outer"], pair["inner"], *a)

            TaskRuntime._PRODUCT_FNS[fn] = fused
        rep = tree_map(lambda x: torch.repeat_interleave(x, bi, dim=0),
                       xs_outer)
        til = tree_map(lambda x: x.repeat((bo,) + (1,) * (x.dim() - 1)),
                       xs_inner)
        flat = self.map(fused, {"outer": rep, "inner": til}, *args,
                        label=label or "map_product")
        return tree_map(lambda y: y.reshape((bo, bi) + tuple(y.shape[1:])),
                        flat)

    # -- futures API -----------------------------------------------------
    def submit(self, fn: Callable[..., Any], xs: Any, *args: Any,
               deps: Sequence[TaskFuture] = (), label: str = ""
               ) -> TaskFuture:
        """Deferred ``map``: returns a TaskFuture immediately.  ``xs`` /
        ``args`` may contain TaskFutures — resolved when gathered."""
        return self._graph.submit("map", fn, xs, args, deps, label)

    def call(self, fn: Callable[..., Any], *args: Any,
             deps: Sequence[TaskFuture] = (), label: str = ""
             ) -> TaskFuture:
        """Deferred host call — the glue nodes between map stages."""
        return self._graph.submit("call", fn, None, args, deps, label)

    def gather(self, futures):
        """Execute the DAG below ``futures`` (deterministic topological
        order) and return their results, preserving structure.  With a
        tracer, every executed node gets a ``dag.task`` span (its chunk
        spans nest inside)."""
        single = isinstance(futures, TaskFuture)
        targets = [futures] if single else list(futures)

        def run_map(f: TaskFuture):
            with maybe_span(self.tracer, "dag.task", cat="dag",
                            label=f.label or f"task{f.task_id}",
                            task_id=f.task_id):
                return self.map(f.fn, resolve(f.xs), *resolve(f.args),
                                label=f.label)

        def run_call(f: TaskFuture):
            with maybe_span(self.tracer, "dag.task", cat="dag",
                            label=f.label or f"task{f.task_id}",
                            task_id=f.task_id):
                return f.fn(*resolve(f.args))

        self._graph.execute(targets, run_map, run_call)
        out = [t.result() for t in targets]
        return out[0] if single else out


def as_runtime(executor, *, memory_budget: int = 0, chunk: int = 0,
               max_retries: int = 2, tracer: Optional[Tracer] = None,
               data_mesh: Optional[DataMesh] = None) -> TaskRuntime:
    """Coerce an executor name / Executor / TaskRuntime into a
    TaskRuntime — the adapter every migrated caller goes through.  A
    TaskRuntime passes through untouched (it keeps its own tracer and
    data mesh); ``tracer`` / ``data_mesh`` attach to freshly-built
    runtimes only."""
    if isinstance(executor, TaskRuntime):
        return executor
    return TaskRuntime(executor, memory_budget=memory_budget, chunk=chunk,
                       max_retries=max_retries, data_mesh=data_mesh,
                       tracer=tracer)
