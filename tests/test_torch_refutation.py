"""The port's refutation suite (repro_torch.core.refutation) held against
the JAX package's (repro.core.refutation) on the same numpy data and
the reference's draws.

torch cannot replay ``jax.random``: each test replaces
``refutation.refute_draws`` with the reference's draws of replicate r —
its key ``fold_in(key, r)`` (``replicate_keys``) gives the permutation,
noise column or subset mask, and the first of its 3 (DML) or 4 (OrthoIV)
splits gives the folds.  Each refuted ATE then matches the reference's
within rtol 1e-4 plus atol 1e-5, as the port's other weighted refits:
fp32 sums in another order (ROADMAP §C: fp32 cross-moments carry ~1e-5
relative error, and the placebo ATEs sit near 0, hence the atol term).
``run_all`` agrees with the reference's on pass/fail; the
weak-instrument screen agrees on its verdict; the refits are bitwise
the same on the serial executor as on the batched one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core import refutation as jref  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.dml import DML as JDML  # noqa: E402
from repro.core.iv import OrthoIV as JOrthoIV  # noqa: E402
from repro.inference.bootstrap import replicate_keys  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import refutation  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.iv import OrthoIV  # noqa: E402

N, P, K, R = 2000, 5, 3, 2
_TOL = dict(rtol=1e-4, atol=1e-5)
_SEEDS = {"placebo_treatment": 7, "random_common_cause": 8,
          "data_subset": 9, "placebo_instrument": 17}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((N, P)).astype(np.float32)
    t = (rng.random(N) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = (2.0 * t + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    z = (rng.random(N) < 0.5).astype(np.float32)
    comply = rng.random(N) < 0.7
    ti = np.where(comply, z, (rng.random(N) < 0.5)).astype(np.float32)
    yi = (1.0 * ti + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    return dict(X=X, t=t, y=y, z=z, ti=ti, yi=yi)


def _cfg(**kw):
    return dict(n_folds=K, **kw)


def _ref_draws(key, n_splits):
    """The reference's draws of replicate r under ``key``, in the port's
    ``refute_draws`` form."""
    keys = replicate_keys(key, 8)

    def draws(kind, seed, ids, n, n_folds, *, frac=0.5, device=None):
        out, folds = [], []
        for r in ids.tolist():
            kr = keys[r]
            if kind == "permute":
                out.append(np.asarray(jax.random.permutation(kr, n)))
            elif kind == "noise":
                out.append(np.asarray(jax.random.normal(kr, (n, 1)))[:, 0])
            else:
                out.append((np.asarray(jax.random.permutation(
                    kr, jnp.arange(n))) < int(n * frac)).astype(np.float32))
            kf = jax.random.split(kr, n_splits)[0]
            folds.append(np.asarray(jfold_ids(kf, n, n_folds)))
        return {"draw": torch.from_numpy(np.stack(out)).to(device),
                "folds": torch.from_numpy(
                    np.stack(folds).astype(np.int64)).to(device)}

    return draws


def _t(x):
    return torch.from_numpy(x)


@pytest.fixture(scope="module")
def fits(data):
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    jest = JDML(JCausalConfig(**_cfg()))
    jbase = jest.fit(jd["y"], jd["t"], jd["X"], key=jax.random.PRNGKey(0))
    est = DML(CausalConfig(**_cfg()), device="cpu")
    base = est.fit(_t(data["y"]), _t(data["t"]), _t(data["X"]))
    return jd, jest, jbase, est, base


@pytest.mark.parametrize("name", ["placebo_treatment", "random_common_cause",
                                  "data_subset"])
def test_refuter_matches_reference(data, fits, monkeypatch, name):
    jd, jest, jbase, est, base = fits
    want = getattr(jref, name)(jest, jd["y"], jd["t"], jd["X"],
                               original_ate=jbase.ate, n_reps=R)
    monkeypatch.setattr(refutation, "refute_draws", _ref_draws(
        jax.random.PRNGKey(_SEEDS[name]), 3))
    got = getattr(refutation, name)(est, _t(data["y"]), _t(data["t"]),
                                    _t(data["X"]), original_ate=base.ate,
                                    n_reps=R)
    np.testing.assert_allclose(got.refuted_ates, want.refuted_ates, **_TOL)
    assert got.passed == want.passed
    assert got.name == want.name and got.expectation == want.expectation
    assert got.row().split(":")[0] == want.row().split(":")[0]


def test_reference_permutation_is_the_permuted_treatment(data):
    """``permutation(kr, t)`` is t re-indexed by ``permutation(kr, n)``:
    the draw the port's placebo indexes with."""
    kr = replicate_keys(jax.random.PRNGKey(7), 1)[0]
    t = jnp.asarray(data["t"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(kr, t)),
        data["t"][np.asarray(jax.random.permutation(kr, N))])


def test_placebo_instrument_and_weak_instrument_match(data, monkeypatch):
    kw = _cfg(nuisance_z="logistic", discrete_instrument=True)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    jest = JOrthoIV(JCausalConfig(**kw))
    jres = jest.fit(jd["yi"], jd["ti"], jd["z"], jd["X"],
                    key=jax.random.PRNGKey(0))
    want = jref.placebo_instrument(jest, jd["yi"], jd["ti"], jd["z"],
                                   jd["X"], original_ate=jres.late,
                                   n_reps=R)
    est = OrthoIV(CausalConfig(**kw), device="cpu")
    res = est.fit(_t(data["yi"]), _t(data["ti"]), _t(data["z"]),
                  _t(data["X"]))
    monkeypatch.setattr(refutation, "refute_draws", _ref_draws(
        jax.random.PRNGKey(17), 4))
    got = refutation.placebo_instrument(
        est, _t(data["yi"]), _t(data["ti"]), _t(data["z"]), _t(data["X"]),
        original_ate=res.late, n_reps=R)
    np.testing.assert_allclose(got.refuted_ates, want.refuted_ates, **_TOL)
    assert got.passed == want.passed
    jw, w = jref.weak_instrument(jres), refutation.weak_instrument(res)
    assert w.passed == jw.passed and w.f_stat > w.threshold
    # the port's own folds: F agrees at the sampling level only
    np.testing.assert_allclose(w.f_stat, jw.f_stat, rtol=0.1)
    np.testing.assert_allclose(w.instrument_corr, jw.instrument_corr,
                               atol=0.02)
    assert "weak_instrument" in w.row()


def test_run_all_agrees_on_pass_fail(data, monkeypatch):
    """The panel as three call nodes gathered on one runtime: the same
    verdicts as the reference's, refit for refit on its draws (run_all
    hands every refuter the one seed, as the reference hands them the
    one key)."""
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    want = jref.run_all(JCausalConfig(**_cfg()), jd["y"], jd["t"], jd["X"])
    monkeypatch.setattr(refutation, "refute_draws", _ref_draws(
        jax.random.PRNGKey(0), 3))
    from repro_torch.obs import Tracer
    tr = Tracer()
    got = refutation.run_all(CausalConfig(**_cfg()), _t(data["y"]),
                             _t(data["t"]), _t(data["X"]), device="cpu",
                             tracer=tr)
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.passed for r in got] == [r.passed for r in want]
    assert all(r.passed for r in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.refuted_ates, w.refuted_ates, **_TOL)
    dag = [s.attrs["label"] for s in tr.spans if s.name == "dag.task"]
    assert dag == ["placebo_treatment", "random_common_cause", "data_subset"]


def test_refits_serial_equal_batched(data):
    """The refits' numbers do not depend on the batch: serial ≡ vmap
    bitwise for each refuter on the port's own draws."""
    est = DML(CausalConfig(**_cfg(row_block=512,
                                  row_block_strategy="pallas")),
              device="cpu")
    args = (_t(data["y"]), _t(data["t"]), _t(data["X"]))
    for name in ("placebo_treatment", "data_subset"):
        fn = getattr(refutation, name)
        a = fn(est, *args, original_ate=2.0, n_reps=R, executor="vmap")
        b = fn(est, *args, original_ate=2.0, n_reps=R, executor="serial")
        assert a.refuted_ates == b.refuted_ates, name


def test_refute_draws_lineage():
    """Replicate r's draws depend on (seed, r) alone; unknown kinds
    raise."""
    a = refutation.refute_draws("noise", 5, torch.arange(3), 50, 3)
    b = refutation.refute_draws("noise", 5, torch.tensor([2]), 50, 3)
    assert torch.equal(a["draw"][2], b["draw"][0])
    assert torch.equal(a["folds"][2], b["folds"][0])
    s = refutation.refute_draws("subset", 5, torch.arange(2), 50, 3,
                                frac=0.3)
    assert s["draw"].sum(1).tolist() == [15.0, 15.0]
    with pytest.raises(ValueError, match="unknown"):
        refutation.refute_draws("bogus", 0, torch.arange(1), 5, 2)
