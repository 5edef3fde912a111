"""Memory-aware replicate batching: how many replicates fit the card.

The model is the reference's: affine in the chunk size,

    peak(c) ≈ base + slope · c

— ``base`` the replicate-independent footprint, ``slope`` the
per-replicate increment (the (c, k, n) weight tensors, the seg_gram
split-partial buffers and the batched solves grow with the batch) —
fitted from probes at chunk 1 and ``PROBE_CHUNK`` and cached per
(closure, input signature).  The scheduler then takes the largest chunk
whose predicted peak stays under ``CausalConfig.runtime_memory_budget``.

How a probe is taken differs.  The reference lowers the vmapped closure
and reads the compiled program's peak without running it; a closure of
the port launches hand-written kernels and cannot be lowered, so on the
card a probe RUNS a chunk: it records ``torch.cuda.memory_allocated``,
resets the allocator's peak, runs the chunk, and reads
``max_memory_allocated`` minus the recorded bytes.  The scheduler keeps
the probe chunks' outputs as the map's first results, so no replicate is
computed twice.  First-call allocations (the cuBLAS workspace, a walk
plan kept in the kernel's cache) land in the first probe; the chunk-1
probe is taken twice and the smaller kept, so they cannot inflate it
into a slope <= 0.  The opposite error — device memory that the host's
cyclic garbage still holds, freed by a collection in the middle of a
probe, which lowers its reading below the chunk's own peak — is ruled
out by collecting the garbage before the probes.

Torch keeps no peak counter on the CPU: there the probe is a function
the caller passes in (``TaskRuntime(probe=...)``), and without one the
model is None and the map runs as one chunk — the reference's own
behaviour when a closure cannot be lowered.

``ChunkCost`` counts one chunk's work from its seg_gram launches
(``count_launches``): per launch of (B, n, qL, qR), 2·B·n·qL·qR
operations (a square Gram its q(q+1)/2 distinct entries) and the bytes
of its inputs plus its (B, S, qL, qR) output — the counts PERF.md §6
bounds each kernel with.  A chunk that launched nothing (the plain
versions on the CPU) has no count: None, never a guess.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.pytree import tree_leaves

PROBE_CHUNK = 8

# chunk size -> peak bytes of a chunk that size (running it), or None
Probe = Callable[[int], Optional[float]]


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Affine peak-memory model of one replicate chunk."""

    base: float  # replicate-independent bytes
    slope: float  # incremental bytes per replicate in the batch
    # the (chunk, peak bytes) readings it was fitted from
    probes: Tuple[Tuple[int, float], ...] = dataclasses.field(
        default=(), compare=False)

    def peak(self, chunk: int) -> float:
        return self.base + self.slope * max(chunk, 0)

    def max_chunk(self, budget_bytes: int, b: int) -> int:
        """Largest chunk (<= b) whose predicted peak fits the budget.
        Never returns less than 1 — a single replicate must run even if
        it alone exceeds the budget (the serial floor)."""
        if budget_bytes <= 0 or self.peak(b) <= budget_bytes:
            return b
        if self.slope <= 0:
            return b
        c = int((budget_bytes - self.base) // self.slope)
        return max(1, min(c, b))


def signature(xs: Any, args: Tuple[Any, ...]) -> Tuple:
    """Shapes and dtypes of one replicate's inputs (the cache key)."""
    out, nx = [], len(tree_leaves(xs))
    for i, leaf in enumerate(tree_leaves((xs, args))):
        shape = tuple(getattr(leaf, "shape", ()))
        if i < nx and shape:
            shape = shape[1:]           # the replicate axis is not signed
        out.append((shape, str(getattr(leaf, "dtype", type(leaf)))))
    return tuple(out)


def input_device(xs: Any, args: Tuple[Any, ...]) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor among the inputs."""
    for leaf in tree_leaves((xs, args)):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def probe_peak_bytes(run: Callable[[], Any], device: Optional[torch.device]
                     ) -> Tuple[Any, Optional[float]]:
    """Run ``run()`` once: (its output, the bytes the CUDA allocator's
    peak rose above what was allocated before it).  Off a CUDA device
    the bytes are None: torch keeps no peak counter there."""
    if device is None or device.type != "cuda":
        return run(), None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = run()
    torch.cuda.synchronize(device)
    return out, float(torch.cuda.max_memory_allocated(device) - before)


def fit_memory_model(probe: Probe, b: int) -> Optional[MemoryModel]:
    """The affine model from probes at chunk 1 (twice, the smaller kept)
    and at ``min(PROBE_CHUNK, b - 2)``, after a collection of the host's
    garbage; the probes take replicates in order, 1 + 1 + c2 of the b.
    None when a probe has no reading."""
    gc.collect()
    readings = []

    def read(c):
        r = probe(c)
        if r is not None:
            readings.append((c, float(r)))
        return r

    p1 = read(1)
    if p1 is None:
        return None
    if b >= 2:
        again = read(1)
        if again is not None:
            p1 = min(p1, again)
    c2 = min(PROBE_CHUNK, b - 2)
    if c2 <= 1:
        return MemoryModel(base=0.0, slope=float(p1), probes=tuple(readings))
    p2 = read(c2)
    if p2 is None:
        return None
    slope = max((p2 - p1) / (c2 - 1), 0.0)
    return MemoryModel(base=max(p1 - slope, 0.0), slope=slope,
                       probes=tuple(readings))


# Closure -> {input signature -> MemoryModel}.  Weak keys let dead
# closures drop out.
_MODEL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_model(fn, xs: Any, args: Tuple[Any, ...]
                 ) -> Tuple[bool, Optional[MemoryModel]]:
    """(found, model) from the cache of ``fn`` at these inputs."""
    per_fn = _MODEL_CACHE.get(fn)
    sig = signature(xs, args)
    if per_fn is None or sig not in per_fn:
        return False, None
    return True, per_fn[sig]


def memory_model(fn, xs: Any, args: Tuple[Any, ...], b: int, probe: Probe
                 ) -> Optional[MemoryModel]:
    """Fit (and cache) the affine peak model for ``fn`` on these input
    shapes, through ``probe`` (which runs the chunks it measures).  A
    closure is probed once per input signature."""
    found, model = cached_model(fn, xs, args)
    if found:
        return model
    model = fit_memory_model(probe, b)
    _MODEL_CACHE.setdefault(fn, {})[signature(xs, args)] = model
    return model


@dataclasses.dataclass(frozen=True)
class ChunkCost:
    """One chunk's measured peak and counted work — what the cost audit
    (``repro_torch.obs.audit``) joins to its measured duration.
    ``flops`` / ``hbm_bytes`` are None where no launch was counted."""

    chunk: int
    peak_bytes: Optional[float]
    flops: Optional[float]
    hbm_bytes: Optional[float]


@dataclasses.dataclass
class LaunchCount:
    """Operations and bytes of the seg_gram launches seen so far."""

    launches: int = 0
    flops: float = 0.0
    hbm_bytes: float = 0.0

    def add(self, key, B, n, S, qL, qR, input_bytes) -> None:
        from repro_torch.kernels.seg_gram import kernel as kern
        flops, nbytes = kern.cost(B, n, S, qL, qR, input_bytes)
        self.launches += 1
        self.flops += flops
        self.hbm_bytes += nbytes


@contextlib.contextmanager
def count_launches() -> Iterator[LaunchCount]:
    """Count the seg_gram launches made inside the block."""
    from repro_torch.kernels.seg_gram import kernel as kern

    count = LaunchCount()
    kern.LAUNCH_OBSERVERS.append(count.add)
    try:
        yield count
    finally:
        kern.LAUNCH_OBSERVERS.remove(count.add)


def probe_chunk_cost(run: Callable[[], Any], chunk: int,
                     device: Optional[torch.device], probe=None
                     ) -> Tuple[Any, ChunkCost]:
    """Run one chunk under the peak probe (``probe(run, chunk) -> (out,
    bytes)``, else the CUDA allocator's on ``device``) and the launch
    count: (its output, its ChunkCost)."""
    with count_launches() as count:
        out, peak = (probe(run, chunk) if probe is not None
                     else probe_peak_bytes(run, device))
    if not count.launches:
        return out, ChunkCost(chunk, peak, None, None)
    return out, ChunkCost(chunk, peak, count.flops, count.hbm_bytes)

