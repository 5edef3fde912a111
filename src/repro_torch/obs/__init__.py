"""repro_torch.obs — zero-dependency observability.

  trace.py    hierarchical span tracer (spans synchronized with the
              card where a value is handed to ``Tracer.sync``), Chrome
              trace-event / Perfetto export, text tree, per-name rollups;
  metrics.py  counters / gauges / histograms with a snapshot API;
  audit.py    predicted-vs-measured cost audit with the H100's roofline
              constants.

Thread ONE ``Tracer`` through ``sweep(tracer=...)``,
``MomentStore(tracer=...)``, ``crossfit(..., tracer=...)`` or
``EffectServer(tracer=...)``; ``tracer=None`` (the default everywhere)
records nothing, so traced and untraced runs compute the same bits.
The task runtime (``repro_torch.runtime``) takes the same tracer:
``runtime.map`` / ``runtime.chunk`` / ``dag.task`` spans, its event and
chunk counters, and an audit row per chunk its memory model sized.
"""
from repro_torch.obs.audit import ChunkAudit, CostAudit
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     reset_default_registry)
from repro_torch.obs.trace import Span, Tracer, maybe_span

__all__ = [
    "ChunkAudit",
    "CostAudit",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "default_registry",
    "maybe_span",
    "reset_default_registry",
]
