"""The port's nuisances and cross-fitting held against the JAX package.

  * ridge and logistic ``fit`` on the same weights (betas and
    predictions), at row_block 0 and at 512 under strategy "pallas"
    (the reference's kernel in interpret mode);
  * the fold-batched fit (weights (k, n)) against k single fits;
  * ``crossfit_one`` on the reference's folds for the "parallel",
    "sequential" and "parallel_loo" engines: out-of-fold predictions
    and fold betas.

Tolerances: oof predictions atol 1e-5 (they are O(1); fp32 Newton
iterates differ by ~1e-6 across frameworks); betas rtol 1e-4 plus atol
1e-5·max|beta|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nuisance as jnu  # noqa: E402
from repro.kernels.seg_gram import ops as jsg_ops  # noqa: E402
# the submodule, not the ``crossfit`` function ``repro_torch.core`` re-exports
tcf = importlib.import_module("repro_torch.core.crossfit")
from repro_torch.core import nuisance as tnu  # noqa: E402

# the submodule, not the ``crossfit`` function ``repro.core`` re-exports
jcf = importlib.import_module("repro.core.crossfit")

_N, _P, _K, _RB = 1100, 5, 5, 512


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    prop = 1.0 / (1.0 + np.exp(-X[:, 0]))
    t = (rng.random(_N) < prop).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0]
         + rng.standard_normal(_N)).astype(np.float32)
    folds = np.array(jcf.fold_ids(jax.random.PRNGKey(3), _N, _K))
    return dict(X=X, y=y, t=t, folds=folds,
                w=rng.exponential(size=_N).astype(np.float32))


def _beta_close(got, want, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=msg)


@pytest.mark.parametrize("rb,st", [(0, None), (_RB, "pallas")])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_fit_matches_reference(data, kind, rb, st):
    jmake = getattr(jnu, f"make_{kind}")
    tmake = getattr(tnu, f"make_{kind}")
    jn, tn = jmake(row_block=rb, strategy=st), tmake(row_block=rb,
                                                     strategy=st)
    target = data["y"] if kind == "ridge" else data["t"]
    with jsg_ops.force_backend("interpret"):
        js = jn.fit(jn.init(jax.random.PRNGKey(0), _P), jnp.asarray(data["X"]),
                    jnp.asarray(target), jnp.asarray(data["w"]))
        jp = jn.predict(js, jnp.asarray(data["X"]))
    X = torch.from_numpy(data["X"])
    ts = tn.fit(tn.init(None, _P), X, torch.from_numpy(target),
                torch.from_numpy(data["w"]))
    tp = tn.predict(ts, X)
    _beta_close(ts["beta"].numpy(), np.asarray(js["beta"]), kind)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_fold_batched_fit_equals_single_fits(data, kind):
    """One (k, n)-weighted fit against k single fits, inside torch."""
    nu = getattr(tnu, f"make_{kind}")(row_block=_RB, strategy="pallas")
    X = torch.from_numpy(data["X"])
    target = torch.from_numpy(data["y"] if kind == "ridge" else data["t"])
    W = tcf.fold_weights(torch.from_numpy(data["folds"]).long(), _K)
    state = {k: torch.stack([v] * _K) for k, v in nu.init(None, _P).items()}
    batched = nu.fit(state, X, target, W)
    for j in range(_K):
        single = nu.fit(nu.init(None, _P), X, target, W[j])
        _beta_close(batched["beta"][j].numpy(), single["beta"].numpy(),
                    f"{kind} fold {j}")


@pytest.mark.parametrize("engine,rb", [("parallel", _RB), ("parallel", 0),
                                       ("sequential", _RB),
                                       ("parallel_loo", _RB)])
@pytest.mark.parametrize("kind", ["ridge", "logistic"])
def test_crossfit_one_matches_reference(data, kind, engine, rb):
    st = "pallas" if rb else None
    jn = getattr(jnu, f"make_{kind}")(row_block=rb, strategy=st)
    tn = getattr(tnu, f"make_{kind}")(row_block=rb, strategy=st)
    target = data["y"] if kind == "ridge" else data["t"]
    joof, jst = jcf.crossfit_one(jn, jax.random.PRNGKey(1),
                                 jnp.asarray(data["X"]), jnp.asarray(target),
                                 jnp.asarray(data["folds"]), _K, engine)
    toof, tst = tcf.crossfit_one(tn, torch.Generator().manual_seed(1),
                                 torch.from_numpy(data["X"]),
                                 torch.from_numpy(target),
                                 torch.from_numpy(data["folds"]).long(), _K,
                                 engine)
    np.testing.assert_allclose(toof.numpy(), np.asarray(joof), atol=1e-5)
    _beta_close(tst["beta"].numpy(), np.asarray(jst["beta"]),
                f"{kind} {engine}")
    assert tuple(tst["lam"].shape) == (_K,)


def test_fold_ids_balanced():
    f = tcf.fold_ids(torch.Generator().manual_seed(0), 1003, _K)
    counts = torch.bincount(f, minlength=_K)
    assert int(counts.max() - counts.min()) <= 1


def test_later_engines_and_nuisances_raise(data):
    from repro_torch.config import CausalConfig

    nu = tnu.make_ridge()
    # any executor name maps the fold axis through the task runtime; the
    # shard_map executor needs a data mesh, and none is active
    with pytest.raises(ValueError, match="DataMesh"):
        tcf.crossfit_one(nu, torch.Generator(), torch.zeros(10, 2),
                         torch.zeros(10), torch.zeros(10, dtype=torch.long),
                         2, engine="shard_map")
    # the mlp kind landed with the metalearners slice; unknown kinds raise
    mlp = tnu.make_nuisance("mlp", "clf", CausalConfig(mlp_hidden=(8,)))
    assert (mlp.name, mlp.task, mlp.hyper["hidden"]) == ("mlp_clf", "clf",
                                                        (8,))
    with pytest.raises(ValueError, match="unknown nuisance kind"):
        tnu.make_nuisance("forest", "reg", CausalConfig())
    # the backbone kind landed with the LM-backbone slice: linear heads
    assert tnu.make_nuisance("backbone", "reg", CausalConfig()).name == "ridge"
