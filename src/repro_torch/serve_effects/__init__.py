"""repro_torch.serve_effects — the online effect-serving layer.

The estimation side (sweep / store) fits once into an ``EffectPanel``;
a deployment then serves those effects to product traffic: per-user
CATE / uplift lookups at high rates, panels refreshed daily by the
store.

  ``ServingPanel``  the immutable scoring artifact of one panel version,
                    on the device that scores — per-segment thetas /
                    SEs / validity out of an ``EffectPanel``, or loaded
                    from a store snapshot (``panel_from_checkpoint``);
  ``scoring``       the wave scorer: ``phi(x) · thetas[sid]`` per row
                    with analytic CI bands, elementwise per row so a
                    wave of any size scores each row bitwise as
                    ``score_single`` does, padded slots included;
  ``EffectServer``  the admission queue, waves on a fixed ladder of
                    shapes (pad-and-mask, ``sid = -1``), one panel
                    version per wave, ``swap`` / ``rollback``, and a
                    per-server ``MetricsRegistry`` with the p50 / p99
                    latency histograms.
"""
from repro_torch.serve_effects.panel import ServingPanel, panel_from_checkpoint
from repro_torch.serve_effects.scoring import (score_batch, score_rows,
                                               score_single)
from repro_torch.serve_effects.server import (EffectServer, QueueFull,
                                              Request, Response, Ticket)

__all__ = [
    "EffectServer",
    "QueueFull",
    "Request",
    "Response",
    "ServingPanel",
    "Ticket",
    "panel_from_checkpoint",
    "score_batch",
    "score_rows",
    "score_single",
]
