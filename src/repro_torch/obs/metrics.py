"""Zero-dependency metrics registry: counters, gauges, histograms.

A copy of the JAX package's registry (it holds no framework value).
Each count and measurement of a run gets a durable, snapshot-able home:

  Counter    monotone occurrence counts ("store.ingests",
             "serve.requests", "serve.swaps");
  Gauge      last-written values ("store.version",
             "serve.queue_depth", "serve.panel_version");
  Histogram  bounded-reservoir distributions ("serve.wave_seconds")
             with exact count/sum/min/max and reservoir percentiles —
             what the serving layer's p50/p99 read.

Everything is plain host-side Python: no tensor is held (callers
convert), so a registry never keeps device memory alive.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional


class Counter:
    """Monotone event counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (None until first set)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution with exact count/sum/min/max and percentiles
    from a bounded reservoir (Algorithm-R uniform sample of ``cap``
    observations — bounded for runtime-lifetime safety).

    The reservoir is a *uniform* sample over the whole observation
    stream, not a prefix: once full, observation ``i`` replaces a
    random slot with probability ``cap / i``, so the percentiles of a
    long-running server track the live distribution instead of
    freezing on warm-up latencies.  Sampling is host-side and
    deterministic per instance (seeded ``random.Random``); count / sum
    / min / max stay exact regardless."""

    __slots__ = ("count", "total", "lo", "hi", "cap", "_values", "_rng")

    def __init__(self, cap: int = 4096, seed: int = 0) -> None:
        self.count = 0
        self.total = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self.cap = int(cap)
        self._values: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.lo = min(self.lo, v)
        self.hi = max(self.hi, v)
        if len(self._values) < self.cap:
            self._values.append(v)
        else:
            # Algorithm R: keep each of the count observations seen so
            # far in the reservoir with equal probability cap/count
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._values[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Reservoir percentile, q in [0, 1] (nearest-rank)."""
        if not self._values:
            return 0.0
        vs = sorted(self._values)
        rank = min(int(q * len(vs)), len(vs) - 1)
        return vs[max(rank, 0)]

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.lo,
            "max": self.hi,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Named get-or-create store for the three instrument kinds, with
    one JSON-friendly ``snapshot()`` for bench reports and tests.

    Most call sites thread an explicit registry (a ``Tracer`` owns
    one); ``default_registry()`` below serves places with no tracer in
    scope."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, cap: int = 4096, seed: int = 0) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(cap=cap, seed=seed)
        return h

    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time view: {"counters": {...}, "gauges": {...},
        "histograms": {name: summary dict}} — plain scalars only."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
        }


# ---------------------------------------------------------------------------
# Process-wide default registry.
# ---------------------------------------------------------------------------

_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide fallback registry (created on first use), for
    instrumentation that runs where no tracer or registry handle can be
    threaded."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


def reset_default_registry() -> None:
    """Drop the process-wide registry (a fresh one is created on next
    use).  Tests reset between cases so same-name counters can never
    couple test order; long-lived processes can reset after shipping a
    snapshot.  Holders of an old ``default_registry()`` handle keep
    writing to the detached instance — callers that want the live one
    re-call ``default_registry()`` (as all in-tree call sites do).

    The serving layer does NOT live here: every ``EffectServer`` owns a
    per-server ``MetricsRegistry`` so two servers in one process never
    share a latency histogram.
    """
    global _DEFAULT
    _DEFAULT = None
