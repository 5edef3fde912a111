"""The sweep's cells mode on the port (masked weighted cells through the
task runtime) held against the reference engine's cells mode on the
same numpy data and the reference's folds and draws.

torch cannot replay ``jax.random``: the tests replace
``repro_torch.sweep.engine.cell_folds`` with the reference's folds of
each cell — cell s of column c has the key
``column_keys(key, c, E)[s]``, and its folds come from the first of its
3 (DML), 4 (OrthoIV, DRLearner) or 5 (DRIV) splits; the S/T/X
metalearners' cells take no folds — and
``engine.ci_draws`` with the reference's replicate draws (replicate b of
segment s: ``fold_in(replicate_keys(ci_key, B)[b], s)`` split into the
weight key and the fit key).  Each cell's θ / ATE / se then matches the
reference's within rtol 1e-4 plus atol 1e-5, the tolerance of the
port's other weighted refits against the reference (fp32 sums in
another order; the atol for values near 0, ROADMAP §C).

Inside torch, bitwise: cells ≡ ``serial_loop`` for every family
(batch-invariant cells), the shared-residual group ≡ its columns alone,
and CIs across chunkings (tests/test_torch_sweep.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.inference.bootstrap import bootstrap_weights as jweights  # noqa: E402
from repro.inference.bootstrap import replicate_keys  # noqa: E402
from repro.sweep import SweepSpec as JSweepSpec  # noqa: E402
from repro.sweep import column_keys as jcolumn_keys  # noqa: E402
from repro.sweep import sweep as jsweep  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.sweep import SweepSpec, column_keys, serial_loop, sweep  # noqa: E402
from repro_torch.sweep import engine  # noqa: E402

N, P, E, K = 900, 4, 3, 2
_KEY = jax.random.PRNGKey(5)
_TOL = dict(rtol=1e-4, atol=1e-5)
_SPLITS = {"dml": 3, "dml_p2_rb": 3, "orthoiv": 4, "drlearner": 4,
           "driv": 5}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((N, P)).astype(np.float32)
    z = (rng.random(N) < 0.5).astype(np.float32)
    t = np.where(rng.random(N) < 0.7, z,
                 rng.random(N) < 1 / (1 + np.exp(-X[:, 0]))
                 ).astype(np.float32)
    y = (1.0 * t + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    return dict(X=X, y=y, t=t, z=z,
                segment_ids=rng.integers(0, E, N).astype(np.int32))


def _cfg(**kw):
    base = dict(n_folds=K, inference="none", newton_iters=6, row_block=256,
                row_block_strategy="pallas", iv_cov_clip=0.1)
    base.update(kw)
    return base


def _ref_cell_folds(columns):
    """{port cell seed: reference folds} for the (estimator, column)
    pairs in ``columns``."""
    table = {}
    for name, c in columns:
        keys = jcolumn_keys(_KEY, c, E)
        for s, seed in enumerate(column_keys(0, c, E).tolist()):
            kf = jax.random.split(keys[s], _SPLITS[name])[0]
            table[seed] = torch.from_numpy(
                np.asarray(jfold_ids(kf, N, K)).astype(np.int64))
    return lambda seed, n, k, device=None: table[int(seed)].to(device)


def _ref_ci_draws(name, col, B, scheme="pairs"):
    """The reference's draws of (replicate b, segment s) of column
    ``col``'s CI, in ``ci_draws``' form."""
    ci_key = jax.random.fold_in(jax.random.fold_in(_KEY, col), 0x0B00)
    bkeys = replicate_keys(ci_key, B)

    def draws(ci_seed, b, sid, n, k, scheme_, device=None):
        kcell = jax.random.fold_in(bkeys[b], jnp.uint32(sid))
        kw, kfit = jax.random.split(kcell)
        w = np.array(jweights(kw, n, scheme))
        kf = jax.random.split(kfit, _SPLITS[name])[0]
        folds = np.asarray(jfold_ids(kf, n, k)).astype(np.int64)
        return (torch.from_numpy(folds).to(device),
                torch.from_numpy(w).to(device))

    return draws


def _jsweep(spec, data, **kw):
    j = {k: jnp.asarray(v) for k, v in data.items()}
    return jsweep(spec, X=j["X"], y=j["y"], t=j["t"], z=j["z"],
                  segment_ids=j["segment_ids"], key=_KEY, mode="cells", **kw)


def _tsweep(spec, data, **kw):
    return sweep(spec, device="cpu", **data, **kw)


def _close(got, want, fields=("thetas", "ates", "ses")):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **_TOL)


@pytest.mark.parametrize("name", ["dml", "orthoiv", "drlearner", "driv",
                                  "s_learner", "t_learner", "x_learner"])
def test_cells_match_reference(data, monkeypatch, name):
    """The metalearners' cells take no folds: only their weights (the
    segment masks) enter, so they match the reference as they are."""
    kw = _cfg()
    want = _jsweep(JSweepSpec(E, ((name, JCausalConfig(**kw)),)), data)
    if name in _SPLITS:
        monkeypatch.setattr(engine, "cell_folds",
                            _ref_cell_folds([(name, 0)]))
    got = _tsweep(SweepSpec(E, ((name, CausalConfig(**kw)),)), data)
    jc, tc = want.columns[0], got.columns[0]
    assert jc.error is None and tc.error is None
    assert (tc.ses is None) == (jc.ses is None)
    _close(tc, jc, ("thetas", "ates") + (("ses",) if jc.ses is not None
                                         else ()))
    assert tc.events == jc.events == ()
    assert bool(got.ok().all())


def test_shared_group_matches_reference(data, monkeypatch):
    """Two DML columns differing in the final stage share one residual
    pass keyed on the first member's cells, in both packages."""
    cfgs = (_cfg(), _cfg(cate_features=2))
    want = _jsweep(JSweepSpec(E, tuple(("dml", JCausalConfig(**c))
                                       for c in cfgs)), data)
    monkeypatch.setattr(engine, "cell_folds", _ref_cell_folds([("dml", 0)]))
    got = _tsweep(SweepSpec(E, tuple(("dml", CausalConfig(**c))
                                     for c in cfgs)), data)
    for tc, jc in zip(got.columns, want.columns):
        assert tc.shared_nuisance == jc.shared_nuisance
        assert tc.key_index == jc.key_index == 0
        _close(tc, jc)


def test_with_ci_matches_reference(data, monkeypatch):
    B = 3
    kw = _cfg(n_bootstrap=B)
    want = _jsweep(JSweepSpec(E, (("dml", JCausalConfig(**kw)),)), data,
                   with_ci=True)
    monkeypatch.setattr(engine, "cell_folds", _ref_cell_folds([("dml", 0)]))
    monkeypatch.setattr(engine, "ci_draws", _ref_ci_draws("dml", 0, B))
    got = _tsweep(SweepSpec(E, (("dml", CausalConfig(**kw)),)), data,
                  with_ci=True)
    jc, tc = want.columns[0], got.columns[0]
    assert tc.events == jc.events == ("ci:pairs",)
    _close(tc, jc, ("thetas", "replicates", "ci_lo", "ci_hi"))


@pytest.mark.parametrize("name", ["dml", "orthoiv", "drlearner", "driv",
                                  "s_learner", "t_learner", "x_learner"])
def test_cells_equal_serial_loop_bitwise(data, name):
    """Cells mode is bitwise a Python loop of the same single fits, one
    cell at a time (proved in torch: the reference's own serial ≡ vmap
    tests are red on this host and no oracle)."""
    cfg = CausalConfig(**_cfg())
    col = _tsweep(SweepSpec(E, ((name, cfg),)), data).columns[0]
    loop = serial_loop(name, cfg, n_segments=E, device="cpu", **data)
    assert torch.equal(loop["theta"], col.thetas)
    assert torch.equal(loop["ate"], col.ates)
    assert ("se" in loop) == (col.ses is not None)
    if col.ses is not None:
        assert torch.equal(loop["se"], col.ses)


def test_shared_group_bitwise_its_columns_alone(data):
    cfg = CausalConfig(**_cfg())
    cfg2 = dataclasses.replace(cfg, cate_features=2)
    shared = _tsweep(SweepSpec(E, (("dml", cfg), ("dml", cfg2))), data)
    alone = _tsweep(SweepSpec(E, (("dml", cfg), ("dml", cfg2))), data,
                    reuse=False)
    # the second column alone draws column 1's cells; shared, column 0's
    assert torch.equal(shared.columns[0].thetas, alone.columns[0].thetas)
    assert shared.columns[1].shared_nuisance
    first_only = _tsweep(SweepSpec(E, (("dml", cfg2),)), data)
    assert torch.equal(shared.columns[1].thetas, first_only.columns[0].thetas)


def test_cells_chunked_and_metalearners_isolated(data):
    """A chunked column (sweep_chunk 2 of E = 3 cells) is bitwise the
    whole one, with its chunk event; an s/t/x column beside it runs on
    its own, bitwise the column swept alone, and a column on the
    shard_map executor with no data mesh fails naming DataMesh without
    touching either."""
    cfg = CausalConfig(**_cfg())
    whole = _tsweep(SweepSpec(E, (("dml", cfg),)), data).columns[0]
    t_alone = _tsweep(SweepSpec(E, (("t_learner", cfg),)), data).columns[0]
    panel = _tsweep(SweepSpec(E, (
        ("dml", dataclasses.replace(cfg, sweep_chunk=2)),
        ("t_learner", cfg),
        ("x_learner", dataclasses.replace(cfg,
                                          inference_executor="shard_map")),
    )), data)
    assert torch.equal(panel.columns[0].thetas, whole.thetas)
    assert panel.columns[0].events == ("chunk:vmap",)
    assert not panel.columns[1].failed
    assert torch.equal(panel.columns[1].ates, t_alone.ates)
    assert panel.columns[2].failed and "DataMesh" in panel.columns[2].error
