"""The port's segmented sweep (repro_torch.sweep) held against the JAX
package's (repro.sweep) on the same numpy inputs and the reference's
folds (torch cannot replay ``jax.random``: the tests hand the
reference's fold ids to the port by replacing
``repro_torch.sweep.segmented.fold_ids``).

  * ``segmented_dml_sweep``: θ and se against the reference's, on the
    "chunked" and "pallas" strategies, with a logistic (MM) and a ridge
    treatment nuisance — rtol/atol 2e-4, the reference's own tolerance
    between its segmented path and per-segment fits (float summation
    order only);
  * ``sweep(mode="segmented")`` against the reference engine's panel;
  * per-column isolation: a column outside the segmented kernels runs
    as cells (an mlp nuisance runs there; a column on the shard_map
    executor with no data mesh fails naming DataMesh), an unknown estimator
    or a missing instrument fail their column only, and the surviving
    column is bitwise the column swept alone;
  * cells mode runs (the default), ``serial_loop`` is bitwise it,
    replicate CIs are bitwise across chunkings, a data mesh that is not
    a DataMesh raises at entry; a traced sweep is bitwise the untraced one,
    with its column, group and runtime spans (the cells against the
    reference's cells: tests/test_torch_sweep_cells.py);
  * per-column checkpoints: resume restores matching columns bitwise,
    a changed config recomputes; the column callback;
  * zero-row segments flagged, spec validation, panel summary, the
    cell-seed lineage and the registry's names.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.sweep import SweepSpec as JSweepSpec  # noqa: E402
from repro.sweep import sweep as jsweep  # noqa: E402
from repro.sweep.segmented import segmented_dml_sweep as jsegmented  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.inference.bootstrap import derive_seed  # noqa: E402
from repro_torch.sweep import (SweepSpec, column_keys, segmented,  # noqa: E402
                               serial_loop, sweep)

N, P, E, K = 1100, 6, 5, 3
_KEY = jax.random.PRNGKey(3)
_TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(**kw):
    base = dict(n_folds=K, inference="none", row_block=256)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    X = rng.standard_normal((N, P)).astype(np.float32)
    t = (rng.random(N) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    tc = (X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    y = (1.2 * t + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    yc = (1.2 * tc + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    sids = rng.integers(0, E, N).astype(np.int32)
    return dict(X=X, t=t, y=y, tc=tc, yc=yc, sids=sids)


def _ref_folds(key):
    return np.asarray(jfold_ids(key, N, K)).astype(np.int64)


@pytest.fixture
def ref_folds(monkeypatch):
    """Hand the reference's fold ids for ``key`` to the port."""
    def use(key):
        folds = torch.from_numpy(_ref_folds(key))
        monkeypatch.setattr(segmented, "fold_ids",
                            lambda gen, n, k, device=None: folds.to(device))
    return use


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
@pytest.mark.parametrize("discrete", [True, False])
def test_segmented_matches_reference(data, ref_folds, strategy, discrete):
    kw = _cfg(row_block_strategy=strategy, cate_features=2,
              discrete_treatment=discrete,
              nuisance_t="logistic" if discrete else "ridge")
    y, t = (data["y"], data["t"]) if discrete else (data["yc"], data["tc"])
    key = jax.random.PRNGKey(7)
    want = jsegmented(JCausalConfig(**kw), jnp.asarray(data["X"]),
                      jnp.asarray(y), jnp.asarray(t),
                      jnp.asarray(data["sids"]), E, key)
    ref_folds(key)
    got = segmented.segmented_dml_sweep(
        CausalConfig(**kw), _t(data["X"]), _t(y), _t(t),
        _t(data["sids"]).long(), E, torch.Generator())
    for f in ("theta", "se", "ate"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   err_msg=f, **_TOL)


def _sweep(spec, data, **kw):
    return sweep(spec, X=data["X"], y=data["y"], t=data["t"],
                 segment_ids=data["sids"], mode="segmented", device="cpu",
                 **kw)


def test_engine_matches_reference(data, ref_folds):
    """Column 0 of the reference engine folds fold_in(key, 0) into its
    key; the port's column 0 gets those folds."""
    kw = _cfg(row_block_strategy="pallas")
    jp = jsweep(JSweepSpec(E, (("dml", JCausalConfig(**kw)),)),
                X=jnp.asarray(data["X"]), y=jnp.asarray(data["y"]),
                t=jnp.asarray(data["t"]), segment_ids=jnp.asarray(
                    data["sids"]), key=_KEY, mode="segmented")
    ref_folds(jax.random.fold_in(_KEY, 0))
    tp = _sweep(SweepSpec(E, (("dml", CausalConfig(**kw)),)), data)
    jc, tc = jp.columns[0], tp.columns[0]
    assert tc.events == jc.events == ("segmented",)
    for f in ("thetas", "ates", "ses"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), err_msg=f,
                                   **_TOL)
    np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    assert bool(tp.ok().all()) and tuple(tp.ok().shape) == (E, 1)


def test_unsupported_column_isolated_naming_runtime(data):
    """A config outside the segmented kernels runs as masked cells
    through the task runtime, as in the reference: a non-DML family
    (drlearner) and an mlp outcome nuisance run there; a column on the
    shard_map executor with no data mesh fails its own column naming
    DataMesh.  The neighbor is bitwise the column swept alone."""
    cfg = CausalConfig(**_cfg())
    mlp = dataclasses.replace(cfg, nuisance_y="mlp", mlp_hidden=(8,),
                              mlp_steps=5)
    sharded = dataclasses.replace(cfg, inference_executor="shard_map")
    panel = _sweep(SweepSpec(E, (("dml", cfg), ("dml", mlp),
                                 ("drlearner", cfg),
                                 ("drlearner", sharded))), data)
    for i in (1, 2):
        col = panel.columns[i]
        assert not col.failed and "segmented" not in col.events
        assert bool(col.ok(panel.counts).all())
        assert bool(torch.isfinite(col.thetas).all())
    bad = panel.columns[3]
    assert bad.failed and "DataMesh" in bad.error
    assert not bool(bad.ok(panel.counts).any())
    alone = _sweep(SweepSpec(E, (("dml", cfg),)), data)
    assert torch.equal(panel.columns[0].thetas, alone.columns[0].thetas)
    assert [i for i, _ in panel.failures()] == [3]
    assert bool(torch.isnan(panel.ate_table()[:, 3]).all())


def test_unknown_estimator_and_missing_instrument_isolated(data):
    cfg = CausalConfig(**_cfg())
    panel = _sweep(SweepSpec(E, (("nope", cfg), ("orthoiv", cfg),
                                 ("dml", cfg))), data)
    assert panel.columns[0].failed and "nope" in panel.columns[0].error
    assert panel.columns[1].failed and "instrument" in panel.columns[1].error
    assert not panel.columns[2].failed


@pytest.mark.parametrize("what", ["cells", "with_ci", "tracer", "data_mesh",
                                  "serial_loop"])
def test_later_features_raise_at_entry(data, what):
    """What the runtime slice brought works — cells mode, per-cell
    replicate CIs, ``serial_loop``, a traced sweep — and a data mesh
    that is not a DataMesh raises at entry (sweeps under a mesh:
    tests/test_torch_mesh_sweep.py)."""
    cfg = CausalConfig(**_cfg())
    spec = SweepSpec(E, (("dml", cfg),))
    kw = dict(X=data["X"], y=data["y"], t=data["t"],
              segment_ids=data["sids"], device="cpu")
    if what == "tracer":
        # the traced sweep is bitwise the untraced one
        from repro_torch.obs import Tracer
        spec2 = SweepSpec(E, (("dml", cfg), ("dml", dataclasses.replace(
            cfg, cate_features=2)), ("drlearner", cfg)))
        tracer = Tracer()
        traced = sweep(spec2, tracer=tracer, mode="segmented", **kw)
        plain = sweep(spec2, mode="segmented", **kw)
        for a, b in zip(traced.columns, plain.columns):
            assert a.error == b.error is None
            assert torch.equal(a.thetas, b.thetas)
            assert torch.equal(a.ses, b.ses)
        names = tracer.span_names()
        assert names[:3] == ["sweep.group:dml", "sweep.column[0]",
                             "sweep.column[1]"]
        assert [s.depth for s in tracer.spans[:3]] == [0, 1, 1]
        assert tracer.spans[1].attrs == {"estimator": "dml",
                                         "segmented": True}
        # the drlearner column runs as cells: the runtime's spans nest
        assert names[3:6] == ["sweep.column[2]", "runtime.map",
                              "runtime.chunk"]
        return
    if what == "data_mesh":
        with pytest.raises(TypeError, match="DataMesh"):
            sweep(spec, data_mesh=object(), mode="segmented", **kw)
        with pytest.raises(ValueError, match="unknown sweep mode"):
            sweep(spec, mode="bogus", **kw)
        return
    cells = sweep(spec, **kw)                       # mode="cells": default
    col = cells.columns[0]
    assert col.error is None and col.events == ()
    assert bool(col.ok(cells.counts).all())
    if what == "cells":
        # the same estimator as the segmented path: the ATEs agree within
        # the sampling noise of the folds (cells draw their own)
        seg = _sweep(spec, data).columns[0]
        assert float((col.ates - seg.ates).abs().max()) < 3 * float(
            seg.ses[:, 0].max())
        assert tuple(col.thetas.shape) == (E, 1)
    elif what == "serial_loop":
        loop = serial_loop("dml", cfg, n_segments=E, **kw)
        for f in ("theta", "se", "ate"):
            assert torch.equal(loop[f], getattr(col, {
                "theta": "thetas", "se": "ses", "ate": "ates"}[f])), f
    else:
        ci = dataclasses.replace(cfg, n_bootstrap=5, sweep_chunk=0)
        one = sweep(SweepSpec(E, (("dml", ci),)), with_ci=True, **kw)
        two = sweep(SweepSpec(E, (("dml", dataclasses.replace(
            ci, sweep_chunk=4)),)), with_ci=True, **kw)
        a, b = one.columns[0], two.columns[0]
        assert a.events == ("ci:pairs",)
        assert b.events[0] == "chunk:vmap" and b.events[-1] == "ci:pairs"
        assert tuple(a.replicates.shape) == (E, 5, 1)
        assert torch.equal(a.replicates, b.replicates)
        assert torch.equal(a.ci_lo, b.ci_lo) and bool((a.ci_lo <= a.ci_hi).all())
        assert torch.equal(a.thetas, col.thetas)


def test_checkpoint_resume_and_callback(data, tmp_path):
    cfg = CausalConfig(**_cfg())
    cfg2 = dataclasses.replace(cfg, cate_features=2)
    # orthoiv without an instrument fails its column: the failed column of
    # the resume; the s_learner column runs as cells and restores
    spec = SweepSpec(E, (("dml", cfg), ("orthoiv", cfg), ("dml", cfg2),
                         ("s_learner", cfg)))
    seen = []
    mgr = CheckpointManager(str(tmp_path), keep_latest=1)
    first = _sweep(spec, data, checkpoint=mgr,
                   column_callback=lambda i, c: seen.append(i))
    assert seen == [0, 2, 1, 3]       # by nuisance group, in spec order
    assert first.columns[1].failed and not first.columns[3].failed
    assert mgr.keep_latest >= 5 and all(mgr.has_step(i) for i in range(4))
    again = _sweep(spec, data, checkpoint=mgr)
    for i in (0, 2, 3):
        assert again.columns[i].events[-1] == "restored"
        assert torch.equal(again.columns[i].thetas, first.columns[i].thetas)
        if first.columns[i].ses is not None:
            assert torch.equal(again.columns[i].ses, first.columns[i].ses)
    # the failed column recomputes; a changed config does not restore
    assert "restored" not in again.columns[1].events
    changed = SweepSpec(E, (("dml", dataclasses.replace(cfg, ridge_lambda=1e-2)),))
    third = _sweep(changed, data, checkpoint=mgr)
    assert third.columns[0].events == ("segmented",)
    fresh = _sweep(spec, data, checkpoint=mgr, resume=False)
    assert fresh.columns[0].events == ("segmented",)


def test_zero_row_segment_flagged(data):
    sids = np.where(data["sids"] == 3, 0, data["sids"]).astype(np.int32)
    panel = sweep(SweepSpec(E, (("dml", CausalConfig(**_cfg(
        row_block_strategy="pallas"))),)), X=data["X"], y=data["y"],
        t=data["t"], segment_ids=sids, mode="segmented", device="cpu")
    col = panel.columns[0]
    assert bool(torch.isfinite(col.thetas).all())
    ok = col.ok(panel.counts)
    assert not bool(ok[3]) and bool(ok[[0, 1, 2, 4]].all())
    assert int(panel.counts[3]) == 0


def test_spec_validation():
    with pytest.raises(ValueError):
        SweepSpec(n_segments=0, columns=(("dml", CausalConfig()),))
    with pytest.raises(ValueError):
        SweepSpec(n_segments=4, columns=())
    spec = SweepSpec.grid(4, estimators=("dml", "drlearner"),
                          configs=(CausalConfig(segment_key="cohort"),))
    assert spec.n_cells == 8 and len(spec.columns) == 2
    assert spec.segment_key == "cohort"


def test_panel_summary(data):
    cfg = CausalConfig(**_cfg(segment_key="cohort"))
    panel = _sweep(SweepSpec.grid(E, estimators=("dml", "s_learner",
                                              "orthoiv"),
                                  configs=(cfg,)), data)
    s = panel.summary()
    assert "cohort" in s and f"{E} segments" in s and "FAILED" in s
    assert tuple(panel.ate_table().shape) == (E, 3)
    assert [i for i, _ in panel.failures()] == [2]      # no instrument


def test_column_keys_lineage():
    keys = column_keys(5, 2, 4)
    assert keys.tolist() == [derive_seed(derive_seed(5, 2), s)
                             for s in range(4)]
    assert keys.tolist() == column_keys(5, 2, 6).tolist()[:4]


def test_registry_mirrors_reference():
    """All ten names, with the reference's instrument flags and base
    configs; DRLearner and DRIV build their weighted cells (no shared-
    nuisance split, as in the reference); so do the metalearners."""
    assert registry.SPEC_IDS == jregistry.SPEC_IDS
    cfg_fields = [f.name for f in dataclasses.fields(CausalConfig)]
    for spec in registry.SPECS:
        ref = jregistry.get_spec(spec.name)
        assert spec.needs_instrument == ref.needs_instrument
        for f in cfg_fields:
            assert getattr(spec.base_cfg, f) == getattr(ref.base_cfg, f), f
        assert registry.nuisance_signature(spec.base_cfg) == \
            jregistry.nuisance_signature(ref.base_cfg)
        if spec.name in ("drlearner", "driv", "s_learner", "t_learner",
                         "x_learner"):
            assert callable(spec.weighted_fit(spec.base_cfg))
            assert spec.residual_fit is None and spec.final_fit is None
            assert (ref.residual_fit, ref.final_fit) == (None, None)
        else:
            assert spec.residual_fit is not None
    with pytest.raises(ValueError, match="unknown estimator"):
        registry.get_spec("nope")


def test_registry_dml_fit_and_weighted_cell(data):
    """The DML family's registry entries run the port's estimators: the
    fit is DML.fit, and the weighted cell on given folds with w = 1 is
    the weighted refit of the bootstrap (dml_theta_once)."""
    from repro_torch.core.dml import DML
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.data.causal_dgp import CausalData

    cfg = CausalConfig(**_cfg(cate_features=2))
    X, y, t = _t(data["X"]), _t(data["y"]), _t(data["t"])
    d = CausalData(X=X, t=t, y=y, true_ate=1.2, true_cate=None,
                   propensity=None)
    spec = registry.get_spec("dml_p2_rb")
    res = spec.fit(d, cfg, torch.Generator().manual_seed(1))
    want = DML(cfg, device="cpu").fit(y, t, X,
                                      gen=torch.Generator().manual_seed(1))
    assert torch.equal(res.theta, want.theta)
    assert spec.point(res) == want.ate
    folds = torch.from_numpy(_ref_folds(_KEY))
    cell = spec.weighted_fit(cfg)
    out = cell(folds, torch.ones(N), {"X": X, "y": y, "t": t,
                                      "phi": cate_basis(X, 2)})
    assert tuple(out["theta"].shape) == (2,) and out["ate"] == out["theta"][0]
    resid = spec.residual_fit(cfg)(folds, torch.ones(N),
                                   {"X": X, "y": y, "t": t})
    fin = spec.final_fit(cfg)(resid, torch.ones(N), {"phi": cate_basis(X, 2)})
    np.testing.assert_allclose(fin["theta"].numpy(), out["theta"].numpy(),
                               rtol=1e-6)
