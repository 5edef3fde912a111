"""The port's DRLearner (repro_torch.core.drlearner, the AIPW refits of
repro_torch.inference.bootstrap) held against the JAX package's.

  * ``DRLearner.fit`` on the reference's folds (``fold_ids``
    monkeypatched, as tests/test_torch_iv.py does for OrthoIV): the arm
    outcome models m0 / m1, the clipped propensity e, the pseudo-outcome
    ψ, the ATE, its se and the CATE θ, at row_block 0 and 256 ("pallas":
    the kernel's plain version on the CPU);
  * ``dr_theta_once`` on the reference's folds and weights (from its
    ``replicate_keys`` / ``fold_ids`` / ``bootstrap_weights``), pairs and
    multiplier: θ, se and the ATE functional's draws;
  * inside torch, bitwise: serial ≡ batched replicates (and their ATE
    draws), one replicate alone ≡ its row, and a B = 3 run a prefix of
    B = 5;
  * "jackknife" maps to the bootstrap, as in the reference; the ATE
    interval is read off the ATE functional's own draws;
  * the registry's ``drlearner`` fit and weighted fit.

Tolerances: rtol 1e-4 plus an atol of 1e-5·max|x| (fp32 cross-moments
carry ~1e-5 relative error between the frameworks, ROADMAP §C; 16-step
Newton propensities and two frameworks' reassociation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import _oof_select as j_oof  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.crossfit import fold_weights as jfold_weights  # noqa: E402
from repro.core.drlearner import DRLearner as JDRLearner  # noqa: E402
from repro.core.nuisance import make_logistic as jmake_logistic  # noqa: E402
from repro.core.nuisance import make_ridge as jmake_ridge  # noqa: E402
from repro.inference import bootstrap as jboot  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import drlearner as tdr  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.final_stage import cate_basis  # noqa: E402
from repro_torch.core.nuisance import make_logistic, make_ridge  # noqa: E402
from repro_torch.data.causal_dgp import CausalData  # noqa: E402
from repro_torch.inference import bootstrap as boot  # noqa: E402

_N, _P, _K, _B, _RB = 1500, 6, 3, 2, 256     # 1500 does not divide 256


def _close(got, want, msg="", rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    t = (rng.random(_N) < 1 / (1 + np.exp(-0.8 * X[:, 1]))).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0] - 0.5 * X[:, 1]
         + rng.standard_normal(_N)).astype(np.float32)
    return X, y, t


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _reference_parts(jest, X, y, t, key):
    """The reference fit's folds, m0, m1 and clipped e, by its own
    steps (``DRLearner.fit`` returns only ψ and θ)."""
    kf, k0, k1, ke = jax.random.split(key, 4)
    folds = jfold_ids(kf, X.shape[0], _K)
    m0 = jest._crossfit_outcome_arm(k0, X, y, t, folds, 0)
    m1 = jest._crossfit_outcome_arm(k1, X, y, t, folds, 1)
    W = jfold_weights(folds, _K)
    keys = jax.random.split(ke, _K)
    st0 = jax.vmap(jest.propensity.init, in_axes=(0, None))(keys, X.shape[1])
    st = jax.vmap(jest.propensity.fit, in_axes=(0, None, None, 0))(
        st0, X, t, W)
    e = j_oof(jax.vmap(jest.propensity.predict, in_axes=(0, None))(st, X),
              folds)
    return folds, m0, m1, jnp.clip(e, jest.clip, 1.0 - jest.clip)


@pytest.mark.parametrize("rb", [0, _RB])
def test_drlearner_matches_reference(data, rb, monkeypatch):
    kw = dict(n_folds=_K, cate_features=2, row_block=rb,
              row_block_strategy="pallas", inference="none")
    JX, jy, jt = (jnp.asarray(a) for a in data)
    key = jax.random.PRNGKey(0)
    jest = JDRLearner(JCausalConfig(**kw))
    jres = jest.fit(jy, jt, JX, key=key)
    jfolds, jm0, jm1, je = _reference_parts(jest, JX, jy, jt, key)
    folds = convert.folds(jfolds, device="cpu")
    monkeypatch.setattr(tdr, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    X, y, t = (_t(a) for a in data)
    est = tdr.DRLearner(CausalConfig(**kw), device="cpu")
    res = est.fit(y, t, X)
    _close(est._crossfit_outcome_arm(X, y, t, folds, 0).numpy(), jm0, "m0")
    _close(est._crossfit_outcome_arm(X, y, t, folds, 1).numpy(), jm1, "m1")
    e = boot.fit_predict_folds(est.propensity, X, t,
                               tdr.fold_weights(folds, _K))
    e = torch.clamp(tdr._oof_select(e, folds), est.clip, 1 - est.clip)
    _close(e.numpy(), je, "e")
    _close(res.pseudo.numpy(), np.asarray(jres.pseudo), "psi")
    _close(res.ate, jres.ate, "ate")
    _close(res.stderr, jres.stderr, "se")
    _close(res.theta.numpy(), np.asarray(jres.theta), "theta")
    _close(res.cate(X[:5]).numpy(), np.asarray(jres.cate(JX[:5])), "cate")
    _close(res.conf_int(), jres.conf_int(), "analytic interval")
    assert res.ate_interval() == res.conf_int()   # inference "none"
    assert "DRLearner" in res.summary() and "ATE" in res.summary()


def _reference_draws(scheme, n_rep):
    """The reference's per-replicate (key, folds, w): its replicate
    closure's split, and the fold key ``dr_theta_once`` takes (the
    first of four)."""
    out = []
    for kb in jboot.replicate_keys(jax.random.PRNGKey(3), n_rep):
        kw, kfit = jax.random.split(kb)
        w = jboot.bootstrap_weights(kw, _N, scheme)
        folds = jfold_ids(jax.random.split(kfit, 4)[0], _N, _K)
        out.append((kfit, np.asarray(folds), np.asarray(w)))
    return out


def _nuisances(rb):
    st = "pallas" if rb else "chunked"
    return (make_ridge(1e-3, row_block=rb, strategy=st),
            make_logistic(1e-3, 16, row_block=rb, strategy=st), st)


@pytest.mark.parametrize("rb", [0, _RB])
@pytest.mark.parametrize("scheme", ["pairs", "multiplier"])
def test_dr_theta_once_matches_reference(data, scheme, rb):
    JX, jy, jt = (jnp.asarray(a) for a in data)
    jphi = jnp.concatenate([jnp.ones((_N, 1)), JX[:, :1]], axis=1)
    jout, jprop = jmake_ridge(1e-3, row_block=rb), jmake_logistic(
        1e-3, 16, row_block=rb)
    draws = _reference_draws(scheme, _B)
    want = [jboot.dr_theta_once(jout, jprop, _K, JX, jy, jt, jphi, key,
                                jnp.asarray(w), row_block=rb)
            for key, _, w in draws]
    outcome, propensity, st = _nuisances(rb)
    X, y, t = (_t(a) for a in data)
    phi = cate_basis(X, 2)
    folds = torch.from_numpy(np.stack([f for _, f, _ in draws])).long()
    w = torch.from_numpy(np.stack([w for _, _, w in draws]))
    got = boot.dr_theta_once(outcome, propensity, _K, X, y, t, phi, folds, w,
                             row_block=rb, strategy=st)
    for f in ("theta", "se", "ate"):
        _close(got[f].numpy(), np.stack([np.asarray(o[f]) for o in want]), f)
    one = boot.dr_theta_once(outcome, propensity, _K, X, y, t, phi, folds[1],
                             w[1], row_block=rb, strategy=st)
    for f in ("theta", "se", "ate"):
        assert torch.equal(one[f], got[f][1]), f


@pytest.mark.parametrize("rb", [0, _RB])
def test_dr_bootstrap_serial_equals_batched(data, rb):
    outcome, propensity, st = _nuisances(rb)
    X, y, t = (_t(a) for a in data)
    kw = dict(n_folds=_K, X=X, y=y, t=t, phi=cate_basis(X, 2), seed=5,
              row_block=rb, strategy=st)
    serial = boot.dr_bootstrap(outcome, propensity, n_replicates=5,
                               executor="serial", **kw)
    batched = boot.dr_bootstrap(outcome, propensity, n_replicates=5,
                                executor="vmap", chunk=3, **kw)
    assert torch.equal(serial.replicates, batched.replicates)
    assert torch.equal(serial.ate_replicates, batched.ate_replicates)
    assert torch.equal(serial.replicate_se, batched.replicate_se)
    short = boot.dr_bootstrap(outcome, propensity, n_replicates=3, **kw)
    assert torch.equal(short.replicates, batched.replicates[:3])
    assert torch.equal(short.ate_replicates, batched.ate_replicates[:3])


def test_jackknife_maps_to_bootstrap_and_ate_draws(data):
    X, y, t = (_t(a) for a in data)
    cfg = CausalConfig(n_folds=_K, cate_features=2, inference="jackknife",
                       n_bootstrap=6, runtime_chunk=4)
    res = tdr.DRLearner(cfg, device="cpu").fit(y, t, X)
    jk = res.inference()
    assert jk.method == "pairs" and jk.n_replicates == 6
    bs = res.inference(method="bootstrap")
    assert torch.equal(jk.replicates, bs.replicates)
    assert jk.ate_point == res.ate and jk.ate_replicates.shape == (6,)
    lo, hi = jk.ate_interval(kind="normal")
    assert abs(0.5 * (lo + hi) - res.ate) < 1e-6
    plo, phi_ = res.ate_interval()
    assert (plo, phi_) == jk.ate_interval()
    assert plo <= float(jk.ate_replicates.median()) <= phi_
    band = res.cate_interval(X[:4])
    assert band[0].shape == (4,) and bool((band[0] <= band[1]).all())


def test_registry_drlearner_fit_and_weighted_cell(data):
    X, y, t = (_t(a) for a in data)
    spec = registry.get_spec("drlearner")
    cfg = CausalConfig(**{**spec.base_cfg.__dict__, "cate_features": 2})
    d = CausalData(X=X, t=t, y=y, true_ate=1.0, true_cate=None,
                   propensity=None)
    res = spec.fit(d, cfg, torch.Generator().manual_seed(0))
    assert isinstance(res, tdr.DRResult) and spec.point(res) == res.ate
    direct = tdr.DRLearner(cfg, device="cpu").fit(
        y, t, X, gen=torch.Generator().manual_seed(0))
    assert res.ate == direct.ate and torch.equal(res.theta, direct.theta)
    folds = tdr.fold_ids(torch.Generator().manual_seed(1), _N, cfg.n_folds)
    cell = spec.weighted_fit(cfg)
    out = cell(folds, torch.ones(_N), {"X": X, "y": y, "t": t,
                                       "phi": cate_basis(X, 2)})
    assert set(out) == {"theta", "se", "ate"}
    assert bool(torch.isfinite(out["theta"]).all())
    assert abs(float(out["ate"]) - direct.ate) < 0.1
