"""The port's OrthoIV slice (repro_torch.core.iv and the instrumented
moments) held against the JAX package's.

  * ``iv_gram`` / ``iv_slices`` / ``iv_meat`` (p_phi = 1 and 2) /
    ``fold_iv_gram`` against ``repro.core.moments`` at row_block 0 and
    256 under "chunked" and "pallas" (the port's plain version on the
    CPU), unbatched and with a leading replicate axis;
  * ``fit_iv_final_stage``, and OrthoIV's θ / cov / LATE, diagnostics
    and jackknife on the reference's folds, against
    ``repro.core.iv.OrthoIV(cfg).fit``; ``delete_fold_jackknife_iv`` and
    ``weighted_iv_theta`` against the reference on the same folds; the
    point fit is the w = 1 weighted replicate bitwise, and a batch of
    replicates row by row;
  * ``make_iv_data`` + OrthoIV recover the true LATE within 4 se
    (jackknife and bootstrap); DRIV builds its compliance nuisance and
    fits (its parity tests: tests/test_torch_driv.py).

Tolerances: Grams rtol 1e-5 plus atol 1e-5·max|G| (fp32 sums in another
order, ~1e-5 relative on cross-moments, ROADMAP §C); θ, cov, jackknife
se and LATE intervals rtol 1e-4 plus atol 1e-4·max|x| (three 16-step
Newton nuisances and two frameworks' reassociation); diagnostics rtol
1e-4, atol 1e-5 (F, correlations and means of O(1) residuals).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core import moments as jm  # noqa: E402
from repro.core.iv import OrthoIV as JOrthoIV  # noqa: E402
from repro.core.iv import fit_iv_final_stage as jfit_iv  # noqa: E402
from repro.inference.jackknife import (  # noqa: E402
    delete_fold_jackknife_iv as jjk_iv)
from repro.inference.numerics import weighted_iv_theta as jwiv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import iv as tiv  # noqa: E402
from repro_torch.core import moments as tm  # noqa: E402
from repro_torch.data.causal_dgp import make_iv_data  # noqa: E402
from repro_torch.inference.jackknife import delete_fold_jackknife_iv  # noqa: E402
from repro_torch.inference.numerics import weighted_iv_theta  # noqa: E402

_N, _P, _K, _RB = 1500, 6, 4, 256


def _close(got, want, msg="", rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    f32 = np.float32
    X = rng.standard_normal((_N, _P)).astype(f32)
    z = (rng.random(_N) < 1 / (1 + np.exp(-X[:, 1]))).astype(f32)
    u = rng.standard_normal(_N).astype(f32)
    t = np.where(rng.random(_N) < 0.7, z,
                 (rng.random(_N) < 1 / (1 + np.exp(-u)))).astype(f32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0] + u
         + rng.standard_normal(_N)).astype(f32)
    res = dict(
        ry=rng.standard_normal(_N).astype(f32),
        rt=rng.standard_normal(_N).astype(f32),
        rz=rng.standard_normal(_N).astype(f32),
        phi=np.concatenate([np.ones((_N, 1), f32), X[:, :1]], axis=1),
        w=rng.exponential(size=_N).astype(f32),
        W=rng.exponential(size=(3, _N)).astype(f32),
        folds=rng.integers(0, _K, _N).astype(np.int32),
        theta=np.array([0.8, -0.3], f32))
    return dict(X=X, y=y, t=t, z=z, **res)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("rb,st", [(0, None), (_RB, "chunked"),
                                   (_RB, "pallas")])
@pytest.mark.parametrize("p", [1, 2])
def test_iv_moments_match_reference(data, p, rb, st):
    d = data
    ry, rt, rz, w = (d[k] for k in ("ry", "rt", "rz", "w"))
    phi, th = d["phi"][:, :p], d["theta"][:p]
    kw = dict(row_block=rb, strategy=st)
    jG, jn = jm.iv_gram(*map(jnp.asarray, (ry, rt, rz, phi, w)), **kw)
    G, n_eff = tm.iv_gram(*map(_t, (ry, rt, rz, phi, w)), **kw)
    _close(G.numpy(), np.asarray(jG), "iv_gram", 1e-5)
    _close(n_eff.numpy(), np.asarray(jn), "n_eff", 1e-6)
    for got, want in zip(tm.iv_slices(G, p), jm.iv_slices(jG, p)):
        _close(got.numpy(), np.asarray(want), "iv_slices", 1e-5)
    for ww in (None, w):
        jM = jm.iv_meat(*map(jnp.asarray, (ry, rt, rz, phi, th)),
                        w=None if ww is None else jnp.asarray(ww), **kw)
        M = tm.iv_meat(*map(_t, (ry, rt, rz, phi, th)),
                       w=None if ww is None else _t(ww), **kw)
        _close(M.numpy(), np.asarray(jM), "iv_meat", 1e-5)
    jGh, jc = jm.fold_iv_gram(*map(jnp.asarray, (ry, rt, rz, phi)),
                              jnp.asarray(d["folds"]), _K, **kw)
    Gh, c = tm.fold_iv_gram(*map(_t, (ry, rt, rz, phi)),
                            _t(d["folds"]).long(), _K, **kw)
    _close(Gh.numpy(), np.asarray(jGh), "fold_iv_gram", 1e-5)
    assert np.array_equal(c.numpy(), np.asarray(jc))

    # a leading replicate axis: row b is the unbatched form with w[b]
    W = d["W"]
    R = W.shape[0]
    cols = [_t(np.broadcast_to(a, (R, _N))) for a in (ry, rt, rz)]
    Gb, nb = tm.iv_gram(*cols, _t(phi), _t(W), **kw)
    thb = _t(np.stack([th * (1 + 0.1 * b) for b in range(R)]))
    Mb = tm.iv_meat(*cols, _t(phi), thb, w=_t(W), **kw)
    for b in range(R):
        Gw, nw = tm.iv_gram(*map(_t, (ry, rt, rz, phi, W[b])), **kw)
        assert torch.equal(Gb[b], Gw) and torch.equal(nb[b], nw)
        Mw = tm.iv_meat(*map(_t, (ry, rt, rz, phi)), thb[b], w=_t(W[b]), **kw)
        assert torch.equal(Mb[b], Mw)


@pytest.mark.parametrize("rb", [0, _RB])
def test_final_stage_and_weighted_theta_match_reference(data, rb):
    d = data
    args = [d[k] for k in ("ry", "rt", "rz", "phi")]
    st = "pallas" if rb else None
    jfs = jfit_iv(*map(jnp.asarray, args), row_block=rb, strategy=st)
    fs = tiv.fit_iv_final_stage(*map(_t, args), row_block=rb, strategy=st)
    _close(fs.theta.numpy(), np.asarray(jfs.theta), "theta")
    _close(fs.cov.numpy(), np.asarray(jfs.cov), "cov")
    _close(fs.j_gram.numpy(), np.asarray(jfs.j_gram), "j_gram")
    # weighted, one replicate and a batch of three
    W = d["W"]
    for b in range(W.shape[0]):
        jth, jse = jwiv(*map(jnp.asarray, args), jnp.asarray(W[b]),
                        row_block=rb, strategy=st)
        th, se = weighted_iv_theta(*map(_t, args), _t(W[b]), row_block=rb,
                                   strategy=st)
        _close(th.numpy(), np.asarray(jth), "weighted theta")
        _close(se.numpy(), np.asarray(jse), "weighted se")
    # the point fit is the w = 1 replicate, bitwise
    th1, se1 = weighted_iv_theta(*map(_t, args), torch.ones(_N),
                                 row_block=rb, strategy=st)
    assert torch.equal(fs.theta, th1) and torch.equal(fs.stderr, se1)
    R = W.shape[0]
    cols = [_t(np.broadcast_to(a, (R, _N))) for a in args[:3]]
    thb, seb = weighted_iv_theta(*cols, _t(args[3]), _t(W), row_block=rb,
                                 strategy=st)
    for b in range(R):
        th, se = weighted_iv_theta(*map(_t, args), _t(W[b]), row_block=rb,
                                   strategy=st)
        assert torch.equal(thb[b], th) and torch.equal(seb[b], se)


@pytest.mark.parametrize("rb", [0, _RB])
def test_orthoiv_matches_reference(data, rb, monkeypatch):
    d = data
    kw = dict(n_folds=5, cate_features=2, row_block=rb,
              row_block_strategy="pallas", inference="jackknife")
    cols = [d[k] for k in ("y", "t", "z")]
    jres = JOrthoIV(JCausalConfig(**kw)).fit(
        *map(jnp.asarray, cols), jnp.asarray(d["X"]),
        key=jax.random.PRNGKey(0))
    jinf = jres.inference()
    folds = convert.folds(jres.crossfit.folds, device="cpu")
    monkeypatch.setattr(tiv, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    res = tiv.OrthoIV(CausalConfig(**kw), device="cpu").fit(
        *map(_t, cols), _t(d["X"]))
    _close(res.theta.numpy(), np.asarray(jres.theta), "theta")
    _close(res.cov.numpy(), np.asarray(jres.cov), "cov")
    assert abs(res.late - jres.late) <= 1e-4 * abs(jres.late)
    for name, want in jres.diagnostics.rows().items():
        got = getattr(res.diagnostics, name)
        if isinstance(want, bool):
            assert got == want, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    inf = res.inference()
    _close(inf.replicates.numpy(), np.asarray(jinf.replicates), "jk draws")
    _close(inf.se.numpy(), np.asarray(jinf.se), "jackknife se")
    _close(res.late_interval(), jres.late_interval(), "LATE interval")
    band, jband = res.cate_interval(_t(d["X"][:5])), jres.cate_interval(
        jnp.asarray(d["X"][:5]))
    for g_, w_ in zip(band, jband):
        _close(g_.numpy(), np.asarray(w_), "CATE band")

    # delete_fold_jackknife_iv by itself, on the same residuals
    cf = res.crossfit
    jk = delete_fold_jackknife_iv(*map(_t, cols), cf.oof_y, cf.oof_t,
                                  cf.oof_z, folds, res.fit_ctx.phi, 5,
                                  row_block=rb, strategy="pallas")
    jjk = jjk_iv(*map(jnp.asarray, cols),
                 *(jnp.asarray(a.numpy()) for a in (cf.oof_y, cf.oof_t,
                                                    cf.oof_z)),
                 jnp.asarray(jres.crossfit.folds),
                 jnp.asarray(res.fit_ctx.phi.numpy()), 5, row_block=rb)
    _close(jk.replicates.numpy(), np.asarray(jjk.replicates), "jk alone")


@pytest.mark.parametrize("method", ["jackknife", "bootstrap"])
def test_make_iv_data_late_recovered(method):
    d = make_iv_data(4000, 6, seed=3, device="cpu")
    cfg = CausalConfig(n_folds=4, inference=method, n_bootstrap=6,
                       row_block=1024, row_block_strategy="pallas")
    res = tiv.OrthoIV(cfg, device="cpu").fit(d.y, d.t, d.z, d.X)
    se = max(float(res.stderr[0]), float(res.inference().se[0]))
    assert abs(res.late - d.true_late) <= 4 * se
    lo, hi = res.late_interval()
    assert lo < res.late < hi or method == "bootstrap"
    assert not res.diagnostics.weak_instrument
    naive = float((d.y * d.t).sum() / d.t.sum()
                  - (d.y * (1 - d.t)).sum() / (1 - d.t).sum())
    assert abs(naive - d.true_late) > abs(res.late - d.true_late)


def test_driv_and_continuous_instrument():
    driv = tiv.DRIV(CausalConfig(), device="cpu")
    assert driv.compliance.name == "ridge" and driv.compliance.task == "reg"
    assert driv.nuis_z.name == "logistic"
    d = make_iv_data(1000, 4, seed=1, device="cpu")
    res = driv.fit(d.y, d.t, d.z, d.X)
    assert res.late == res.ate and np.isfinite(res.late)
    assert res.fit_ctx.compliance is driv.compliance
    cfg = CausalConfig(discrete_instrument=False)
    est = tiv.OrthoIV(cfg, device="cpu")
    assert est.nuis_z.name == "ridge" and est.nuis_z.task == "reg"
    b = torch.tensor([-0.5, -0.01, 0.0, 0.02, 0.4])
    assert torch.equal(tiv.clip_compliance(b, 0.1),
                       torch.tensor([-0.5, -0.1, 0.1, 0.1, 0.4]))
