"""EffectServer: admission queue + wave batching + versioned hot-swap.

  * Requests enter a bounded admission queue (``submit``; a full queue
    raises ``QueueFull``: backpressure is explicit, never a silent
    drop).
  * ``step()`` drains one *wave*: up to ``max(wave_sizes)`` requests,
    padded to the smallest configured wave size that fits, so every
    wave has one of ``len(wave_sizes)`` shapes.  Padded slots carry
    ``sid = -1`` and are no-ops (``scoring``).  A wave's requests are
    staged to the panel's device in one copy of X and one of the
    segment ids, and its results come back in one copy.
  * Each wave captures ONE ``ServingPanel`` reference at entry: a
    ``swap()`` between waves affects the next wave, so no request is
    scored against a mix of versions.  ``swap`` keeps the outgoing
    version on a history stack; ``rollback()`` re-installs it.
  * Observability is per server: a ``MetricsRegistry`` owned by the
    server (never ``obs.metrics.default_registry()``: two servers in one
    process must not share a latency histogram) records request-latency,
    wave-latency and occupancy histograms and queue / version gauges;
    an optional ``Tracer`` wraps every wave in a ``serve.wave`` span.

The loop is synchronous and single-threaded (drive it with ``step()``,
``drain()`` or ``score()``): determinism is a test contract here.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.inference.intervals import z_crit
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import maybe_span
from repro_torch.serve_effects.panel import ServingPanel
from repro_torch.serve_effects.scoring import score_batch

_FIELDS = ("cate", "lo", "hi", "se", "ok")


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One scoring request: a feature row and its segment id."""

    x: np.ndarray  # (p,) features, fp32
    segment_id: int


@dataclasses.dataclass
class Response:
    """One scored effect: point estimate, CI band, validity, lineage."""

    cate: float
    lo: float
    hi: float
    se: float
    ok: bool  # False => flagged (failed cell / bad segment id)
    version: int  # the ONE panel version this request scored on
    latency_s: float  # submit -> response, the wave's results on the host


@dataclasses.dataclass
class Ticket:
    """Queue handle returned by ``submit``; ``response`` fills on the
    wave that serves it."""

    request: Request
    submitted_at: float
    response: Optional[Response] = None

    @property
    def done(self) -> bool:
        """Whether the owning wave has completed."""
        return self.response is not None


class EffectServer:
    """Wave-batched CATE / uplift scorer over versioned ServingPanels;
    waves are scored on the panel's device."""

    def __init__(self, panel: ServingPanel, *,
                 wave_sizes: Sequence[int] = (8, 64), max_queue: int = 1024,
                 alpha: float = 0.05,
                 registry: Optional[MetricsRegistry] = None, tracer=None):
        if not wave_sizes or any(w < 1 for w in wave_sizes):
            raise ValueError(f"serve: bad wave_sizes {wave_sizes!r}")
        self._panel = panel
        self._history: List[ServingPanel] = []
        self.wave_sizes: Tuple[int, ...] = tuple(sorted(set(wave_sizes)))
        self.max_queue = int(max_queue)
        self.alpha = float(alpha)
        self._z = z_crit(alpha)
        self._queue: Deque[Ticket] = deque()
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer

    # -- panel versions -------------------------------------------------
    @property
    def panel(self) -> ServingPanel:
        """The panel version the NEXT wave will score against."""
        return self._panel

    @property
    def version(self) -> int:
        """Version id of the installed panel."""
        return self._panel.version

    def swap(self, panel: ServingPanel) -> None:
        """Install a refreshed panel version (one reference assignment
        between waves); the outgoing one goes on the rollback stack."""
        self._history.append(self._panel)
        self._panel = panel
        self.metrics.counter("serve.swaps").inc()
        self.metrics.gauge("serve.panel_version").set(panel.version)

    def rollback(self) -> ServingPanel:
        """Re-install the previous panel version (raises when there is
        no history); returns the version rolled back TO."""
        if not self._history:
            raise RuntimeError("serve: no panel version to roll back to")
        self._panel = self._history.pop()
        self.metrics.counter("serve.rollbacks").inc()
        self.metrics.gauge("serve.panel_version").set(self._panel.version)
        return self._panel

    # -- admission ------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet served."""
        return len(self._queue)

    def submit(self, x, segment_id: int) -> Ticket:
        """Admit one request; raises ``QueueFull`` at capacity."""
        if len(self._queue) >= self.max_queue:
            self.metrics.counter("serve.rejected").inc()
            raise QueueFull(
                f"serve: admission queue at capacity ({self.max_queue})")
        x = np.asarray(x, np.float32)
        if x.shape != (self._panel.n_features,):
            raise ValueError(f"serve: request x must be "
                             f"({self._panel.n_features},), got {x.shape}")
        ticket = Ticket(Request(x=x, segment_id=int(segment_id)),
                        submitted_at=time.perf_counter())
        self._queue.append(ticket)
        self.metrics.counter("serve.requests").inc()
        self.metrics.gauge("serve.queue_depth").set(len(self._queue))
        return ticket

    # -- the wave loop --------------------------------------------------
    def _wave_shape(self, n: int) -> int:
        """Smallest configured wave size that fits n requests."""
        for w in self.wave_sizes:
            if n <= w:
                return w
        return self.wave_sizes[-1]

    def step(self) -> List[Ticket]:
        """Serve one wave; an empty queue is a free no-op.

        Pops up to ``max(wave_sizes)`` requests, pads them to the chosen
        wave shape, scores them against the panel version captured at
        wave entry, and fills each ticket's ``Response``."""
        if not self._queue:
            return []
        panel = self._panel  # ONE version for this whole wave
        cap = self.wave_sizes[-1]
        wave = [self._queue.popleft()
                for _ in range(min(len(self._queue), cap))]
        n = len(wave)
        w = self._wave_shape(n)
        with maybe_span(self.tracer, "serve.wave", cat="serve", wave_size=w,
                        fill=n, version=panel.version):
            t0 = time.perf_counter()
            X = np.zeros((w, panel.n_features), np.float32)
            X[:n] = np.stack([t.request.x for t in wave])
            sids = np.full((w,), -1, np.int64)  # the segment-Gram pad id
            sids[:n] = [t.request.segment_id for t in wave]
            out = score_batch(panel, X, sids, self._z)
            # one copy back: the five fields as fp32 rows (ok as 0 / 1)
            host = torch.stack([out[f].to(torch.float32)
                                for f in _FIELDS]).cpu().numpy()
            t1 = time.perf_counter()
        cols = [host[i, :n].tolist() for i in range(len(_FIELDS))]
        hist = self.metrics.histogram("serve.request_seconds")
        for i, t in enumerate(wave):
            lat = t1 - t.submitted_at
            t.response = Response(cate=cols[0][i], lo=cols[1][i],
                                  hi=cols[2][i], se=cols[3][i],
                                  ok=bool(cols[4][i]), version=panel.version,
                                  latency_s=lat)
            hist.observe(lat)
        m = self.metrics
        m.counter("serve.waves").inc()
        m.counter("serve.scored").inc(n)
        m.histogram("serve.wave_seconds").observe(t1 - t0)
        m.histogram("serve.batch_occupancy").observe(n / w)
        m.gauge("serve.queue_depth").set(len(self._queue))
        return wave

    def drain(self) -> List[Ticket]:
        """Run waves until the queue is empty; returns served tickets."""
        served: List[Ticket] = []
        while self._queue:
            served.extend(self.step())
        return served

    def score(self, X, segment_ids) -> List[Response]:
        """Synchronous burst: submit every row of ``X`` through the
        admission queue (draining whenever it fills) and return the
        responses in request order."""
        X = np.asarray(X, np.float32)
        sids = np.asarray(segment_ids)
        tickets: List[Ticket] = []
        for i in range(X.shape[0]):
            if len(self._queue) >= self.max_queue:
                self.drain()
            tickets.append(self.submit(X[i], int(sids[i])))
        self.drain()
        return [t.response for t in tickets]

    # -- observability --------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """The server's metrics snapshot (plain JSON scalars)."""
        return self.metrics.snapshot()
