"""Hierarchical host-side span tracer with Chrome-trace export.

Spans open around sweep columns, store ingests and refreshes, cross-fit
targets and serving waves, nest by call structure (a host-side stack),
and — where the caller hands the produced value to :meth:`Tracer.sync`
— close only after the card has finished the work behind it, so their
durations measure executed work, not the launch.

Exports:

  chrome_trace()       Chrome trace-event JSON ("X" complete events,
                       "i" instants) — load the file in Perfetto
                       (https://ui.perfetto.dev) or chrome://tracing;
  render()             indented text tree with durations;
  rollup()             per-span-name {count, total_s, max_s}.

A ``Tracer`` owns its :class:`~repro_torch.obs.metrics.MetricsRegistry`
and :class:`~repro_torch.obs.audit.CostAudit`, so integrations thread
one object.  ``tracer=None`` everywhere means no spans and no
synchronization: traced and untraced runs launch the same kernels on
the same inputs, so their outputs are the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterator, List, Optional, Set

import torch

from repro_torch.obs.audit import CostAudit
from repro_torch.obs.metrics import MetricsRegistry


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _cuda_devices(value: Any, out: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor reachable in ``value`` (tensors,
    mappings, sequences, dataclass fields)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


@dataclasses.dataclass
class Span:
    """One traced interval (or instant, when ``end_ns == start_ns``)."""

    span_id: int
    name: str
    cat: str
    start_ns: int
    end_ns: int = -1  # -1 while open
    parent_id: int = -1
    depth: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def open(self) -> bool:
        """Whether the span has not closed yet."""
        return self.end_ns < 0

    @property
    def duration_s(self) -> float:
        """Seconds from open to close (0 while open)."""
        if self.open:
            return 0.0
        return max(self.end_ns - self.start_ns, 0) / 1e9


class Tracer:
    """Span stack + completed-span log + metrics + cost audit.

    ``sync=True`` (default) makes :meth:`sync` wait for the card, so
    span durations cover the device work; set False to trace the host's
    scheduling alone.
    """

    def __init__(self, *, sync: bool = True, clock=time.perf_counter_ns):
        self._clock = clock
        self.sync_enabled = bool(sync)
        self.spans: List[Span] = []  # in open order; closed in place
        self._stack: List[Span] = []
        self._next_id = 0
        self.metrics = MetricsRegistry()
        self.audit = CostAudit()

    def _new(self, name: str, cat: str, attrs: Dict[str, Any], start: int,
             end: int = -1, instant: bool = False) -> Span:
        parent = self._stack[-1] if self._stack else None
        s = Span(span_id=self._next_id, name=name, cat=cat, start_ns=start,
                 end_ns=end, parent_id=parent.span_id if parent else -1,
                 depth=len(self._stack),
                 attrs={k: _jsonable(v) for k, v in attrs.items()},
                 instant=instant)
        self._next_id += 1
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "runtime", **attrs
             ) -> Iterator[Span]:
        """Open a nested span; yields it so callers can attach attrs."""
        s = self._new(name, cat, attrs, self._clock())
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.end_ns = self._clock()

    def instant(self, name: str, cat: str = "event", **attrs) -> Span:
        """Zero-duration marker."""
        now = self._clock()
        return self._new(name, cat, attrs, now, now, instant=True)

    def sync(self, value: Any) -> Any:
        """Wait for every CUDA device that holds a tensor of ``value``
        (``torch.cuda.synchronize``), inside an open span, so its
        duration covers the device work that produced ``value``.  Values
        on the CPU pass through; a failed synchronize raises."""
        if self.sync_enabled:
            for dev in sorted(_cuda_devices(value, set()), key=str):
                torch.cuda.synchronize(dev)
        return value

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (a dict; ``json.dump`` it).
        Timestamps are microseconds from the first span; complete spans
        are ph="X", instants ph="i"."""
        t0 = min((s.start_ns for s in self.spans), default=0)
        events: List[Dict[str, Any]] = []
        for s in self.spans:
            base = {"name": s.name, "cat": s.cat,
                    "ts": (s.start_ns - t0) / 1e3, "pid": 1, "tid": 1,
                    "args": dict(s.attrs)}
            if s.instant:
                events.append({**base, "ph": "i", "s": "t"})
            else:
                end = s.end_ns if not s.open else s.start_ns
                events.append({**base, "ph": "X",
                               "dur": max(end - s.start_ns, 0) / 1e3})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path

    def render(self) -> str:
        """Indented text tree (spans in open order, depth-indented)."""
        lines = []
        for s in self.spans:
            pad = "  " * s.depth
            if s.instant:
                lines.append(f"{pad}! {s.name} {s.attrs or ''}".rstrip())
            else:
                lines.append(f"{pad}{s.name} [{s.cat}] "
                             f"{s.duration_s * 1e3:.2f}ms"
                             + (f" {s.attrs}" if s.attrs else ""))
        return "\n".join(lines)

    def rollup(self) -> Dict[str, Dict[str, float]]:
        """Per-name duration rollup over completed non-instant spans."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            if s.instant or s.open:
                continue
            r = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                        "max_s": 0.0})
            r["count"] += 1
            r["total_s"] += s.duration_s
            r["max_s"] = max(r["max_s"], s.duration_s)
        return out

    def span_names(self) -> List[str]:
        """Span names in open order."""
        return [s.name for s in self.spans]


@contextlib.contextmanager
def maybe_span(tracer: Optional[Tracer], name: str, cat: str = "runtime",
               **attrs):
    """``tracer.span(...)`` when tracing, a free no-op otherwise — the
    one-liner integrations use so ``tracer=None`` costs nothing."""
    if tracer is None:
        yield None
    else:
        with tracer.span(name, cat=cat, **attrs) as s:
            yield s
