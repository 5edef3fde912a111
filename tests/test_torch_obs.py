"""The port's observability layer (repro_torch.obs) against the JAX
package's (repro.obs), mirroring tests/test_obs.py:

  * metrics: counters, gauges, histograms with exact aggregates, the
    seeded reservoir (the same draws as the reference's for the same
    stream — both are Python's ``random.Random``), the default registry's
    reset;
  * the tracer: span nesting and rollup, the Chrome-trace schema (strict
    JSON, tensors stringified), ``maybe_span(None)``; ``Tracer.sync`` on
    CPU values passes through;
  * the cost audit with the H100's constants (3.35 TB/s, 67 TFLOP/s
    fp32, 989 TFLOP/s bf16), not the reference's TPU ones;
  * traced ≡ untraced bitwise for a cross-fit, with its spans (the
    sweep's and the store's are in tests/test_torch_{sweep,store}.py).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import Histogram as JHistogram  # noqa: E402
from repro.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro_torch.obs import (ChunkAudit, CostAudit, Histogram,  # noqa: E402
                             MetricsRegistry, Tracer, maybe_span)
from repro_torch.obs import audit as taudit  # noqa: E402


def test_counter_gauge_histogram_match_reference():
    regs = (MetricsRegistry(), JMetricsRegistry())
    for reg in regs:
        reg.counter("a").inc()
        reg.counter("a").inc(4)
        reg.gauge("g").set(2.5)
        for v in [1.0, 2.0, 3.0, 4.0]:
            reg.histogram("h").observe(v)
    snap = regs[0].snapshot()
    assert snap == regs[1].snapshot()
    assert snap["counters"]["a"] == 5 and snap["gauges"]["g"] == 2.5
    h = snap["histograms"]["h"]
    assert h["count"] == 4 and h["sum"] == 10.0
    assert h["min"] == 1.0 and h["max"] == 4.0
    assert h["mean"] == pytest.approx(2.5)
    reg = regs[0]
    assert reg.counter("a") is reg.counter("a")
    assert reg.histogram("h") is reg.histogram("h")


def test_histogram_reservoir_cap_shift_and_seed():
    h = Histogram(cap=10)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100 and h.hi == 99.0 and h.lo == 0.0
    assert len(h._values) == 10
    assert h.percentile(0.0) <= h.percentile(0.5) <= h.percentile(1.0)
    assert Histogram().summary() == {"count": 0, "sum": 0.0}
    # the reservoir follows a shift after it fills
    cap = 64
    h = Histogram(cap=cap)
    for _ in range(cap):
        h.observe(1.0)
    for _ in range(20 * cap):
        h.observe(10.0)
    assert h.percentile(0.5) == 10.0 and h.percentile(0.99) == 10.0
    assert h.total == cap * 1.0 + 20 * cap * 10.0

    def fill(cls, seed):
        hh = cls(cap=8, seed=seed)
        for v in range(1000):
            hh.observe(float(v))
        return list(hh._values)

    assert fill(Histogram, 0) == fill(Histogram, 0) != fill(Histogram, 1)
    # the same seeded Algorithm R as the reference: the same sample
    assert fill(Histogram, 3) == fill(JHistogram, 3)


def test_reset_default_registry_decouples():
    from repro_torch.obs.metrics import (default_registry,
                                         reset_default_registry)

    default_registry().counter("coupling.probe").inc(3)
    assert default_registry().snapshot()["counters"]["coupling.probe"] == 3
    reset_default_registry()
    fresh = default_registry()
    assert "coupling.probe" not in fresh.snapshot()["counters"]
    assert default_registry() is fresh


def test_span_nesting_and_rollup():
    tr = Tracer()
    with tr.span("outer", cat="test", tag="a") as so:
        with tr.span("inner"):
            tr.instant("mark", detail="x")
        with tr.span("inner"):
            pass
    assert so.depth == 0 and not so.open
    inners = [s for s in tr.spans if s.name == "inner"]
    assert all(s.parent_id == so.span_id and s.depth == 1 for s in inners)
    mark = next(s for s in tr.spans if s.name == "mark")
    assert mark.instant and mark.depth == 2 and mark.duration_s == 0.0
    roll = tr.rollup()
    assert roll["inner"]["count"] == 2 and "mark" not in roll
    assert roll["outer"]["total_s"] >= roll["inner"]["total_s"]
    text = tr.render()
    assert "outer" in text and "  inner" in text and "! mark" in text


def test_chrome_trace_schema(tmp_path):
    tr = Tracer()
    with tr.span("work", cat="runtime", label="L", size=torch.tensor(3)):
        tr.instant("event")
    path = tr.write_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert len(evs) == 2
    for e in evs:
        assert {"name", "cat", "ts", "pid", "tid", "ph", "args"} <= set(e)
        assert e["ph"] in ("X", "i") and e["ts"] >= 0.0
        for v in e["args"].values():
            assert isinstance(v, (str, int, float, bool, type(None)))
    x = next(e for e in evs if e["ph"] == "X")
    assert x["dur"] >= 0.0 and x["name"] == "work"
    i = next(e for e in evs if e["ph"] == "i")
    assert i["s"] == "t" and "dur" not in i


def test_maybe_span_none_and_sync_passthrough():
    with maybe_span(None, "anything") as s:
        assert s is None
    tr = Tracer()
    with maybe_span(tr, "real", cat="c", k=1) as s:
        assert s is not None and s.name == "real"
        value = {"a": torch.ones(3), "b": [torch.zeros(2), 1.5], "c": "x"}
        assert tr.sync(value) is value
    assert tr.span_names() == ["real"]


def test_audit_with_h100_constants():
    assert (taudit.HBM_BW, taudit.PEAK_FLOPS_FP32,
            taudit.PEAK_FLOPS_BF16) == (3.35e12, 67e12, 989e12)
    assert taudit.PEAK_FLOPS == taudit.PEAK_FLOPS_FP32
    zero = ChunkAudit(label="z", chunk_index=0, chunk_size=1,
                      predicted_peak_bytes=0.0, probed_peak_bytes=0.0,
                      flops=0.0, hbm_bytes=0.0, measured_s=0.0)
    assert np.isfinite(zero.peak_ratio) and np.isfinite(zero.time_ratio())
    audit = CostAudit()
    assert audit.summary() == {"n_chunks": 0}
    row = ChunkAudit(label="boot", chunk_index=0, chunk_size=4,
                     predicted_peak_bytes=1000.0, probed_peak_bytes=800.0,
                     flops=6.7e10, hbm_bytes=6.7e9, measured_s=0.01)
    audit.record(row)
    # 6.7e10 FLOP at 67 TFLOP/s = 1 ms; 6.7e9 B at 3.35 TB/s = 2 ms
    assert row.roofline_s() == pytest.approx(2e-3)
    assert row.time_ratio() == pytest.approx(5.0)
    assert row.roofline_s(taudit.PEAK_FLOPS_BF16) == pytest.approx(2e-3)
    s = audit.summary()
    assert s["n_chunks"] == 1 and s["labels"] == ["boot"]
    assert s["peak_ratio_min"] == pytest.approx(1.25)
    assert s["time_ratio_min"] == pytest.approx(5.0)
    assert "boot" in audit.table() and "meas_peak" in audit.table()
    d = audit.as_dicts()[0]
    assert d["roofline_s"] == pytest.approx(2e-3) and len(audit) == 1


def test_traced_crossfit_bitwise_untraced():
    from repro_torch.core.crossfit import crossfit
    from repro_torch.core.nuisance import make_logistic, make_ridge

    g = torch.Generator().manual_seed(0)
    X = torch.randn((600, 5), generator=g)
    t = (torch.rand(600, generator=g) < torch.sigmoid(X[:, 0])).float()
    y = t + X[:, 0] + torch.randn(600, generator=g)
    ny = make_ridge(1e-3, row_block=128, strategy="pallas")
    nt = make_logistic(1e-3, 8, row_block=128, strategy="pallas")
    tracer = Tracer()
    a = crossfit(ny, nt, torch.Generator().manual_seed(1), X, y, t, 3,
                 tracer=tracer)
    b = crossfit(ny, nt, torch.Generator().manual_seed(1), X, y, t, 3)
    assert torch.equal(a.oof_y, b.oof_y) and torch.equal(a.oof_t, b.oof_t)
    # each crossfit span holds the task runtime's map and chunk spans
    assert tracer.span_names() == [
        "crossfit:ridge", "runtime.map", "runtime.chunk",
        "crossfit:logistic", "runtime.map", "runtime.chunk"]
    assert tracer.spans[0].attrs == {"k": 3, "n": 600, "backend": "parallel"}
