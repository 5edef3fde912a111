"""The port's effect-serving layer (repro_torch.serve_effects), mirroring
tests/test_serve_effects.py inside torch, and held against the JAX
package's scorer on the same panel.

Contracts (bitwise, inside torch):
  * wave scoring (pad-and-mask, every wave shape of a ladder, the
    server's default (8, 64) included) ≡ ``score_single``, and padded
    slots are flagged no-ops that garbage cannot perturb;
  * one panel version per wave; a hot-swap between waves changes the
    served estimates without dropping a request, and rollback re-installs
    the earlier version bit for bit — through the port's checkpoints;
  * failed cells and out-of-range segments are flagged, never NaN;
  * backpressure (``QueueFull``), bad shapes, rollback without history;
  * per-server metrics, never the process-global registry; wave spans,
    and tracing changes no bits.
Against the reference: the port's scores of a panel carried over by
``convert.serving_panel`` against ``repro.serve_effects``' on the same
requests, at 1e-6 relative (the same fp32 operations; XLA may fuse the
sum into an FMA).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.serve_effects import ServingPanel as JServingPanel  # noqa: E402
from repro.serve_effects.scoring import score_batch as jscore_batch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, default_registry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve_effects import (EffectServer, QueueFull,  # noqa: E402
                                       ServingPanel, panel_from_checkpoint,
                                       score_batch, score_single)
from repro_torch.store import MomentStore  # noqa: E402
from repro_torch.sweep import SweepSpec  # noqa: E402

N, E, P = 1100, 5, 6
_FIELDS = ("cate", "lo", "hi", "se", "ok")


def _cfg() -> CausalConfig:
    return CausalConfig(n_folds=3, inference="none", row_block=256,
                        nuisance_t="ridge", discrete_treatment=False,
                        cate_features=2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    X = rng.standard_normal((N, P)).astype(np.float32)
    t = (X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    y = ((1.2 + 0.3 * X[:, 0]) * t + X[:, 0]
         + rng.standard_normal(N)).astype(np.float32)
    sids = rng.integers(0, E, N).astype(np.int64)
    return dict(X=X, y=y, t=t, segment_ids=sids)


@pytest.fixture(scope="module")
def spec():
    return SweepSpec(E, (("dml", _cfg()),))


def _rows(d, lo, hi):
    return {k: v[lo:hi] for k, v in d.items()}


@pytest.fixture(scope="module")
def store(spec, data):
    s = MomentStore(spec, n_features=P, seed=11, device="cpu")
    s.ingest(**data)
    return s


@pytest.fixture(scope="module")
def panel(store):
    return ServingPanel.from_effect_panel(store.refresh(), n_features=P,
                                          version=store.version)


def _server(panel, **kw):
    kw.setdefault("wave_sizes", (4, 16))
    kw.setdefault("max_queue", 64)
    return EffectServer(panel, **kw)


def _same(a, b):
    return (a.cate, a.lo, a.hi, a.se, a.ok) == (b.cate, b.lo, b.hi, b.se,
                                                b.ok)


@pytest.mark.parametrize("ladder", [(4, 16), (8, 64), (1,), (3, 5, 7)])
def test_batched_scoring_bitwise_unbatched(panel, data, ladder):
    srv = _server(panel, wave_sizes=ladder, max_queue=256)
    X, ids = data["X"][:70], data["segment_ids"][:70]
    responses = srv.score(X, ids)
    for i, r in enumerate(responses):
        ref = score_single(panel, X[i], int(ids[i]), srv._z)
        assert r.cate == float(ref["cate"]) and r.lo == float(ref["lo"])
        assert r.hi == float(ref["hi"]) and r.se == float(ref["se"])
        assert r.ok == bool(ref["ok"]) and r.version == panel.version
    assert all(r.ok for r in responses)


def test_wave_shape_invariance_bitwise(panel, data):
    X, ids = data["X"][:3], data["segment_ids"][:3]
    small = _server(panel, wave_sizes=(4,)).score(X, ids)
    large = _server(panel, wave_sizes=(16,)).score(X, ids)
    ones = _server(panel, wave_sizes=(1,)).score(X, ids)
    for a, b, c in zip(small, large, ones):
        assert _same(a, b) and _same(b, c)


def test_padded_slots_are_flagged_noops(panel, data):
    X = np.zeros((8, P), np.float32)
    X[0] = data["X"][0]
    sids = np.full((8,), -1, np.int64)
    sids[0] = 2
    out = score_batch(panel, X, sids, 1.96)
    assert not bool(out["ok"][1:].any())
    assert bool((out["cate"][1:] == 0).all() and (out["lo"][1:] == 0).all())
    X2 = X.copy()
    X2[1:] = 1e30
    out2 = score_batch(panel, X2, sids, 1.96)
    for k in _FIELDS:
        assert torch.equal(out[k][0], out2[k][0])


def test_empty_wave_single_request_and_backpressure(panel, data):
    srv = _server(panel)
    assert srv.step() == [] and srv.drain() == []
    assert srv.snapshot()["counters"].get("serve.waves", 0) == 0
    t = srv.submit(data["X"][0], 1)
    assert not t.done and srv.queue_depth == 1
    (served,) = srv.step()
    assert served is t and t.done and srv.queue_depth == 0
    assert np.isfinite(t.response.cate) and t.response.latency_s > 0
    assert t.response.lo <= t.response.cate <= t.response.hi
    srv = _server(panel, wave_sizes=(4,), max_queue=8)
    for _ in range(8):
        srv.submit(data["X"][0], 0)
    with pytest.raises(QueueFull):
        srv.submit(data["X"][0], 0)
    assert srv.snapshot()["counters"]["serve.rejected"] == 1
    served = srv.drain()
    assert len(served) == 8 and all(t.done for t in served)
    srv.submit(data["X"][0], 0)
    with pytest.raises(ValueError, match="request x"):
        srv.submit(np.zeros((P + 1,), np.float32), 0)
    with pytest.raises(ValueError, match="wave_sizes"):
        EffectServer(panel, wave_sizes=(0, 4))


def test_failed_cells_and_out_of_range_segments_flagged(data, panel):
    spec0 = SweepSpec(3, (("dml", _cfg()),))
    s = MomentStore(spec0, n_features=P, device="cpu")
    s.ingest(**{**data, "segment_ids": np.zeros(N, np.int64)})
    sp = ServingPanel.from_effect_panel(s.refresh(), n_features=P,
                                        version=s.version)
    good, bad = _server(sp).score(data["X"][:2], [0, 1])
    assert good.ok and np.isfinite(good.cate)
    assert not bad.ok and (bad.cate, bad.lo, bad.hi, bad.se) == (0, 0, 0, 0)
    lo, hi = _server(panel).score(data["X"][:2], [-3, E + 7])
    for r in (lo, hi):
        assert not r.ok and r.cate == 0.0 and not np.isnan(r.cate)
    failed = MomentStore(SweepSpec(E, (("drlearner", _cfg()),)),
                         n_features=P, device="cpu")
    with pytest.raises(ValueError, match="failed"):
        ServingPanel.from_effect_panel(failed.refresh(), n_features=P)


def test_hot_swap_one_version_per_wave(spec, data):
    s = MomentStore(spec, n_features=P, seed=11, device="cpu")
    s.ingest(**_rows(data, 0, 512))
    p1 = ServingPanel.from_effect_panel(s.refresh(), n_features=P,
                                        version=s.version)
    s.ingest(**_rows(data, 512, N))
    p2 = ServingPanel.from_effect_panel(s.refresh(), n_features=P,
                                        version=s.version)
    srv = _server(p1, wave_sizes=(4,))
    tickets = [srv.submit(data["X"][0], 1) for _ in range(8)]
    wave1 = srv.step()
    srv.swap(p2)
    wave2 = srv.step()
    assert {t.response.version for t in wave1} == {p1.version}
    assert {t.response.version for t in wave2} == {p2.version}
    assert len(wave1) + len(wave2) == len(tickets)
    assert wave1[0].response.cate != wave2[0].response.cate


def test_hot_swap_and_rollback_through_checkpoints(tmp_path, spec, data):
    manager = CheckpointManager(str(tmp_path), keep_latest=8)
    s = MomentStore(spec, n_features=P, seed=11, device="cpu")
    s.ingest(**_rows(data, 0, 512))
    v1 = s.save(manager)
    s.ingest(**_rows(data, 512, N))
    v2 = s.save(manager)
    p1 = panel_from_checkpoint(manager, spec, P, seed=11, step=v1,
                               device="cpu")
    srv = _server(p1)
    X, ids = data["X"][:20], data["segment_ids"][:20]
    r1 = srv.score(X, ids)
    assert {r.version for r in r1} == {v1}
    latest = panel_from_checkpoint(manager, spec, P, seed=11, device="cpu")
    assert latest.version == v2
    srv.swap(latest)
    r2 = srv.score(X, ids)
    assert {r.version for r in r2} == {v2}
    assert any(a.cate != b.cate for a, b in zip(r1, r2))
    assert srv.rollback().version == v1
    r3 = srv.score(X, ids)
    assert all(_same(a, b) and b.version == v1 for a, b in zip(r1, r3))
    snap = srv.snapshot()["counters"]
    assert snap["serve.swaps"] == 1 and snap["serve.rollbacks"] == 1
    other = SweepSpec(E, (("dml_loo", _cfg()),))
    with pytest.raises(ValueError, match="columns"):
        panel_from_checkpoint(manager, other, P, device="cpu")
    with pytest.raises(RuntimeError, match="roll back"):
        _server(p1).rollback()


def test_metrics_per_server_and_tracing(panel, data):
    a, b = _server(panel), _server(panel)
    X, ids = data["X"][:9], data["segment_ids"][:9]
    a.score(X[:6], ids[:6])
    snap_a, snap_b = a.snapshot(), b.snapshot()
    assert snap_a["counters"]["serve.requests"] == 6
    assert "serve.requests" not in snap_b["counters"]
    assert "serve.requests" not in default_registry().snapshot()["counters"]
    hist = snap_a["histograms"]["serve.request_seconds"]
    assert hist["count"] == 6 and hist["p99"] >= hist["p50"] > 0
    assert 0 < snap_a["histograms"]["serve.batch_occupancy"]["max"] <= 1.0
    reg = MetricsRegistry()
    _server(panel, registry=reg).score(X[:1], ids[:1])
    assert reg.snapshot()["counters"]["serve.requests"] == 1
    tracer = Tracer()
    traced = _server(panel, tracer=tracer).score(X, ids)
    plain = _server(panel).score(X, ids)
    waves = [s for s in tracer.spans if s.name == "serve.wave"]
    assert waves and waves[0].attrs["version"] == panel.version
    assert sum(s.attrs["fill"] for s in waves) == 9
    assert all(_same(p, q) for p, q in zip(traced, plain))


def test_scores_match_reference_on_the_same_panel():
    rng = np.random.default_rng(5)
    pf = 2
    thetas = rng.standard_normal((E, pf)).astype(np.float32)
    ses = rng.uniform(0.01, 0.2, (E, pf)).astype(np.float32)
    ok = np.array([True, True, False, True, True])
    thetas[4, 1] = np.nan                           # a non-finite cell
    X = rng.standard_normal((64, P)).astype(np.float32)
    sids = rng.integers(-1, E + 1, 64).astype(np.int64)
    jp = JServingPanel(thetas=jnp.asarray(thetas), ses=jnp.asarray(ses),
                       ok=jnp.asarray(ok), n_features=P, cate_features=pf)
    tp = convert.serving_panel(thetas, ses, ok, n_features=P, device="cpu")
    want = jscore_batch(jp, X, sids.astype(np.int32), 1.959963984540054)
    got = score_batch(tp, X, sids, 1.959963984540054)
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    for f in _FIELDS[:4]:
        w = np.asarray(want[f], np.float64)
        np.testing.assert_allclose(got[f].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=f)
    assert got["ok"].sum() > 30 and not bool(got["ok"][sids == 2].any())
