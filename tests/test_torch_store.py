"""The port's effect store (repro_torch.store) held against the JAX
package's (repro.store) on the same numpy inputs, and its own contracts
inside torch.

Against the reference, on the reference's folds (torch cannot replay
``jax.random.fold_in``: the tests replace the port's ``_row_folds``
with the reference's draw for the same column key):

  * accumulators and refreshed panel of every store-supported registry
    estimator, on "chunked" and "pallas" — 2e-3, the reference's own
    tolerance between its store and a float64 dense refit
    (tests/test_store.py); they agree to ~1e-6 in practice;
  * ``refresh_column`` from the reference's accumulators carried over
    by ``convert.store_state`` — 2e-4 (the same solves, different
    summation order).

Inside torch, bitwise: aligned ingest partitions against one ingest
(every supported estimator), an empty ingest, rollback through the
checkpoint manager; and the misaligned-ingest flag per column,
streaming-stable folds (the port's own splitmix64 draw), the coverage
gate's reasons, a provenance mismatch, zero-row segments, the effect
recovered, a traced store bitwise the untraced one with its spans and
counters, a data mesh that is not a DataMesh refused (stores under a
mesh: tests/test_torch_mesh_sweep.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.store.store as jstore_mod  # noqa: E402
from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.store import MomentStore as JMomentStore  # noqa: E402
from repro.sweep.spec import SweepSpec as JSweepSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core.registry import SPEC_IDS, get_spec  # noqa: E402
from repro_torch.store import MomentStore, store_supported  # noqa: E402
from repro_torch.store import store as store_mod  # noqa: E402
from repro_torch.store.solve import refresh_column  # noqa: E402
from repro_torch.sweep import SweepSpec  # noqa: E402

N, E, P, RB = 1100, 5, 6, 256
_KEY = jax.random.PRNGKey(11)
SUPPORTED = ("dml", "dml_p2_rb", "dml_loo", "orthoiv", "orthoiv_p2_rb")
UNSUPPORTED = tuple(n for n in SPEC_IDS if n not in SUPPORTED)


def _kw(name, **extra):
    """The canonical store config: all-ridge nuisances, continuous
    treatment, blocked rows (the bitwise-contract regime)."""
    kw = dict(n_folds=3, inference="none", row_block=RB, nuisance_t="ridge",
              nuisance_z="ridge", discrete_treatment=False,
              cate_features=2 if "p2" in name else 1)
    kw.update(extra)
    return kw


def _cfg(name, **extra):
    return CausalConfig(**_kw(name, **extra))


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(42)
    X = rng.standard_normal((N, P)).astype(np.float32)
    z = (rng.random(N) < 0.5).astype(np.float32)
    t = (X[:, 0] + z + rng.standard_normal(N)).astype(np.float32)
    y = (1.2 * t + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    sids = rng.integers(0, E, N).astype(np.int32)
    return dict(X=X, y=y, t=t, z=z, segment_ids=sids)


def _kw_rows(name, rows):
    kw = dict(rows)
    if not get_spec(name).needs_instrument:
        kw.pop("z")
    return kw


def _sliced(kw, lo, hi):
    return {k: v[lo:hi] for k, v in kw.items()}


def _ingest(spec, kw, cuts, device="cpu"):
    store = MomentStore(spec, n_features=P, seed=0, device=device)
    bounds = [0, *cuts, kw["X"].shape[0]]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        store.ingest(**_sliced(kw, lo, hi))
    return store


def _states_equal(a, b):
    fa, fb = a.state_dict(), b.state_dict()
    assert set(fa) == set(fb)
    assert torch.equal(fa["seg_counts"], fb["seg_counts"])
    for c in fa:
        if c != "seg_counts":
            for key in ("ng", "vg", "counts"):
                assert torch.equal(fa[c][key], fb[c][key]), (c, key)


def _panels_equal(pa, pb):
    for ca, cb in zip(pa.columns, pb.columns):
        assert ca.error == cb.error
        if ca.error is None:
            for f in ("thetas", "ses", "ates"):
                assert torch.equal(getattr(ca, f), getattr(cb, f)), f
    assert torch.equal(pa.counts, pb.counts)


@pytest.fixture
def ref_row_folds(monkeypatch):
    """The port's column 0 draws the reference column 0's folds."""
    def folds(col_seed, start, n, k):
        f = jstore_mod._row_folds(jax.random.fold_in(_KEY, 0), start, n, k)
        return torch.from_numpy(np.asarray(f).astype(np.int64))
    monkeypatch.setattr(store_mod, "_row_folds", folds)


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
@pytest.mark.parametrize("name", SUPPORTED)
def test_store_matches_reference(rows, ref_row_folds, name, strategy):
    kw = _kw_rows(name, rows)
    cuts = (2 * RB,)
    jspec = JSweepSpec(E, ((name, JCausalConfig(**_kw(
        name, row_block_strategy=strategy))),))
    js = JMomentStore(jspec, n_features=P, key=_KEY)
    bounds = [0, *cuts, N]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        js.ingest(**{k: jnp.asarray(v) for k, v in _sliced(kw, lo, hi)
                     .items()})
    ts = _ingest(SweepSpec(E, ((name, _cfg(name, row_block_strategy=strategy)),)),
                 kw, cuts)
    want, got = js.state_dict()["col0"], ts.state_dict()["col0"]
    for key in ("ng", "vg", "counts"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=2e-3,
                                   atol=2e-3 * np.abs(w).max(), err_msg=key)
    jc, tc = js.refresh().columns[0], ts.refresh().columns[0]
    for f in ("thetas", "ses", "ates"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=2e-3,
                                   atol=2e-3, err_msg=f)
    assert tc.aligned is jc.aligned is True


@pytest.mark.parametrize("name", ("dml", "dml_p2_rb", "orthoiv"))
def test_refresh_from_converted_state(rows, name):
    """The reference's accumulators, carried over, refresh to its panel."""
    kw = {k: jnp.asarray(v) for k, v in _kw_rows(name, rows).items()}
    cfg = _cfg(name)
    js = JMomentStore(JSweepSpec(E, ((name, JCausalConfig(**_kw(name))),)),
                      n_features=P, key=_KEY)
    js.ingest(**kw)
    np_state = {k: np.asarray(v) for k, v in js.state_dict()["col0"].items()}
    state = convert.store_state(np_state, device="cpu")
    layout = store_mod.ColumnLayout(
        p=P, pf=store_mod._basis_width(P, cfg.cate_features), k=cfg.n_folds,
        iv=get_spec(name).needs_instrument)
    got = refresh_column(layout, state, E, ridge_lambda=cfg.ridge_lambda)
    want = js.refresh().columns[0]
    for f, g in (("thetas", "theta"), ("ses", "se"), ("ates", "ate")):
        np.testing.assert_allclose(got[g].numpy(),
                                   np.asarray(getattr(want, f)), rtol=2e-4,
                                   atol=2e-4, err_msg=f)


@pytest.mark.parametrize("name", SUPPORTED)
def test_ingest_partition_bitwise(rows, name):
    kw = _kw_rows(name, rows)
    spec = SweepSpec(E, ((name, _cfg(name)),))
    full = _ingest(spec, kw, ())
    inc = _ingest(spec, kw, (2 * RB,))
    _states_equal(full, inc)
    _panels_equal(full.refresh(), inc.refresh())
    assert full.aligned and inc.aligned
    inc3 = _ingest(spec, kw, (RB, 3 * RB))
    _states_equal(full, inc3)
    _panels_equal(full.refresh(), inc3.refresh())


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_unsupported_estimators_gated(rows, name):
    ok, reason = store_supported(get_spec(name), _cfg(name))
    assert not ok and "store" in reason
    spec = SweepSpec(E, (("dml", _cfg("dml")), (name, _cfg(name))))
    panel = _ingest(spec, dict(rows), (2 * RB,)).refresh()
    assert panel.columns[1].failed and "store" in panel.columns[1].error
    assert panel.columns[0].error is None
    assert bool(panel.columns[0].ok(panel.counts).all())
    ref = _ingest(SweepSpec(E, (("dml", _cfg("dml")),)),
                  _kw_rows("dml", rows), ())
    assert torch.equal(panel.columns[0].thetas,
                       ref.refresh().columns[0].thetas)


@pytest.mark.parametrize("field", ["discrete_treatment", "nuisance_y",
                                   "nuisance_t"])
def test_gate_reasons(field):
    bad = {"discrete_treatment": dict(discrete_treatment=True),
           "nuisance_y": dict(nuisance_y="mlp"),
           "nuisance_t": dict(nuisance_t="logistic")}[field]
    ok, reason = store_supported(get_spec("dml"), _cfg("dml", **bad))
    assert not ok and field.split("_")[-1] in reason
    ok, reason = store_supported(get_spec("orthoiv"),
                                 _cfg("orthoiv", nuisance_z="logistic"))
    assert not ok and "nuisance_z" in reason


def test_empty_ingest_is_exact_noop(rows):
    spec = SweepSpec(E, (("dml", _cfg("dml")),))
    kw = _kw_rows("dml", rows)
    a = _ingest(spec, kw, ())
    b = MomentStore(spec, n_features=P, seed=0, device="cpu")
    b.ingest(**_sliced(kw, 0, 0))
    b.ingest(**_sliced(kw, 0, 2 * RB))
    b.ingest(**_sliced(kw, N, N))
    b.ingest(**_sliced(kw, 2 * RB, N))
    b.ingest(**_sliced(kw, 0, 0))
    _states_equal(a, b)
    _panels_equal(a.refresh(), b.refresh())
    assert b.n_ingests == 5 and b.version == 5 and b.n_total == N


def test_misaligned_ingest_flags_tolerance_regime(rows, tmp_path):
    cfg_a = _cfg("dml")
    cfg_b = dataclasses.replace(cfg_a, row_block=3 * RB // 4)
    spec = SweepSpec(E, (("dml", cfg_a), ("dml", cfg_b)))
    kw = _kw_rows("dml", rows)
    s = _ingest(spec, kw, (2 * RB,))
    assert s.column_aligned == (True, False) and not s.aligned
    panel = s.refresh()
    assert panel.columns[0].aligned is True
    assert panel.columns[1].aligned is False
    assert "misaligned" in panel.summary()
    full = _ingest(spec, kw, ())
    assert torch.equal(panel.columns[0].thetas,
                       full.refresh().columns[0].thetas)
    np.testing.assert_allclose(panel.columns[1].thetas.numpy(),
                               full.refresh().columns[1].thetas.numpy(),
                               rtol=2e-4, atol=2e-4)
    manager = CheckpointManager(str(tmp_path), keep_latest=4)
    s.save(manager)
    restored = MomentStore(spec, n_features=P, seed=0, device="cpu")
    restored.restore(manager)
    assert restored.column_aligned == (True, False)
    u = _ingest(SweepSpec(E, (("dml", cfg_a), ("drlearner", cfg_a))), kw, ())
    assert u.column_aligned == (True, None) and u.aligned


def test_fold_assignment_streaming_stable():
    spec = SweepSpec(E, (("dml", _cfg("dml")), ("dml", _cfg("dml"))))
    store = MomentStore(spec, n_features=P, seed=3, device="cpu")
    whole = store.fold_assignment(0, 0, N)
    head = store.fold_assignment(0, 0, 512)
    tail = store.fold_assignment(0, 512, N - 512)
    assert torch.equal(whole, torch.cat([head, tail]))
    assert set(whole.tolist()) == {0, 1, 2}
    # columns draw independent folds; another seed, other folds
    assert not torch.equal(whole, store.fold_assignment(1, 0, N))
    other = MomentStore(spec, n_features=P, seed=4, device="cpu")
    assert not torch.equal(whole, other.fold_assignment(0, 0, N))
    counts = torch.bincount(whole, minlength=3).float()
    assert float(counts.min()) > 0.25 * N


def test_zero_row_segment_flagged_not_crashed(rows):
    spec = SweepSpec(3, (("dml", _cfg("dml")),))
    store = MomentStore(spec, n_features=P, seed=0, device="cpu")
    store.ingest(X=rows["X"], y=rows["y"], t=rows["t"],
                 segment_ids=np.zeros(N, np.int32))
    panel = store.refresh()
    col = panel.columns[0]
    assert bool(torch.isfinite(col.thetas).all())
    ok = col.ok(panel.counts)
    assert bool(ok[0]) and not bool(ok[1]) and not bool(ok[2])


def test_dml_recovers_effect(rows):
    spec = SweepSpec(E, (("dml", _cfg("dml")),))
    ates = _ingest(spec, _kw_rows("dml", rows), ()).refresh().columns[0].ates
    assert bool(((ates - 1.2).abs() < 0.2).all())


def test_checkpoint_rollback_bitwise(rows, tmp_path):
    spec = SweepSpec(E, (("dml", _cfg("dml")),))
    kw = _kw_rows("dml", rows)
    manager = CheckpointManager(str(tmp_path), keep_latest=8)
    store = MomentStore(spec, n_features=P, seed=0, device="cpu")
    store.ingest(**_sliced(kw, 0, 2 * RB))
    v1 = store.save(manager)
    p1 = store.refresh()
    store.ingest(**_sliced(kw, 2 * RB, N))
    v2 = store.save(manager)
    p2 = store.refresh()
    assert manager.latest_step() == v2 and v2 > v1
    assert not torch.equal(p1.columns[0].thetas, p2.columns[0].thetas)
    store.restore(manager, step=v1)
    assert store.version == v1 and store.n_total == 2 * RB
    _panels_equal(store.refresh(), p1)
    store.restore(manager)
    _panels_equal(store.refresh(), p2)
    store.restore(manager, step=v1)
    store.ingest(**_sliced(kw, 2 * RB, N))
    _panels_equal(store.refresh(), p2)


def test_checkpoint_provenance_mismatch_raises(rows, tmp_path):
    manager = CheckpointManager(str(tmp_path), keep_latest=8)
    a = MomentStore(SweepSpec(E, (("dml", _cfg("dml")),)), n_features=P,
                    device="cpu")
    a.ingest(**_kw_rows("dml", rows))
    a.save(manager)
    b = MomentStore(SweepSpec(E, (("dml_loo", _cfg("dml_loo")),)),
                    n_features=P, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        b.restore(manager)


def test_ingest_checks_and_later_features(rows):
    spec = SweepSpec(E, (("orthoiv", _cfg("orthoiv")),))
    store = MomentStore(spec, n_features=P, device="cpu")
    with pytest.raises(ValueError, match="requires z"):
        store.ingest(**_kw_rows("dml", rows))
    with pytest.raises(ValueError, match=r"\(n, 6\)"):
        store.ingest(**{**rows, "X": rows["X"][:, :4]})
    from repro_torch.obs import Tracer
    tracer = Tracer()
    traced = MomentStore(spec, n_features=P, tracer=tracer, device="cpu")
    plain = MomentStore(spec, n_features=P, device="cpu")
    for st in (traced, plain):
        st.ingest(**_sliced(rows, 0, 512))
        st.ingest(**_sliced(rows, 512, N))
    _states_equal(traced, plain)
    _panels_equal(traced.refresh(), plain.refresh())
    assert tracer.span_names() == ["store.ingest", "store.ingest",
                                   "store.refresh"]
    snap = tracer.metrics.snapshot()
    assert snap["counters"]["store.ingest.rows"] == N
    assert snap["counters"]["store.refreshes"] == 1
    assert snap["gauges"]["store.version"] == 2
    with pytest.raises(TypeError, match="DataMesh"):
        MomentStore(spec, n_features=P, data_mesh=object(), device="cpu")
