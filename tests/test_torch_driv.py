"""The port's DRIV (repro_torch.core.iv.DRIV, the DRIV refits of
repro_torch.inference.bootstrap) held against the JAX package's.

  * ``DRIV.fit`` on the reference's folds (``fold_ids`` monkeypatched):
    the preliminary θ_pre, the pseudo-outcome ψ, the LATE, its se, the
    CATE θ and the instrument diagnostics, at row_block 0 and 256
    ("pallas": the kernel's plain version on the CPU);
  * ``driv_theta_once`` on the reference's folds and weights (from its
    ``replicate_keys`` / ``fold_ids`` / ``bootstrap_weights``), pairs and
    multiplier: θ, se and the LATE functional's draws;
  * ``clip_compliance`` against the reference's;
  * inside torch, bitwise: serial ≡ batched replicates and their LATE
    draws, one replicate alone ≡ its row;
  * ``method="jackknife"`` raises ``ValueError`` as in the reference;
    the registry's ``driv`` fit and weighted fit.

Tolerances: rtol 1e-4 plus an atol of 1e-5·max|x| (ROADMAP §C's
cross-moment error; four nuisances, two of them 16-step Newton fits,
and ψ divides by the clipped compliance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.iv import DRIV as JDRIV  # noqa: E402
from repro.core.iv import clip_compliance as jclip  # noqa: E402
from repro.core.iv import iv_crossfit as jiv_crossfit  # noqa: E402
from repro.core.nuisance import make_nuisance as jmake_nuisance  # noqa: E402
from repro.core.nuisance import make_ridge as jmake_ridge  # noqa: E402
from repro.inference import bootstrap as jboot  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import iv as tiv  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.final_stage import cate_basis  # noqa: E402
from repro_torch.core.nuisance import make_nuisance, make_ridge  # noqa: E402
from repro_torch.data.causal_dgp import make_iv_data  # noqa: E402
from repro_torch.inference import bootstrap as boot  # noqa: E402

_N, _P, _K, _B, _RB = 1500, 6, 4, 2, 256


def _close(got, want, msg="", rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
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
    return X, y, t, z


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def test_clip_compliance_matches_reference():
    b = np.array([-0.5, -0.1, -0.01, 0.0, 0.02, 0.1, 0.4], np.float32)
    for clip in (0.1, 0.05):
        got = tiv.clip_compliance(_t(b), clip)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jclip(jnp.asarray(b), clip)))
    assert bool((tiv.clip_compliance(_t(b), 0.1).abs() >= 0.1).all())


@pytest.mark.parametrize("rb", [0, _RB])
def test_driv_matches_reference(data, rb, monkeypatch):
    kw = dict(n_folds=_K, cate_features=2, row_block=rb,
              row_block_strategy="pallas", inference="none")
    jargs = [jnp.asarray(a) for a in (data[1], data[2], data[3], data[0])]
    key = jax.random.PRNGKey(0)
    jres = JDRIV(JCausalConfig(**kw)).fit(*jargs, key=key)
    jcfg = JCausalConfig(**kw)
    jcf = jiv_crossfit(jmake_nuisance("ridge", "reg", jcfg),
                       jmake_nuisance("logistic", "clf", jcfg),
                       jmake_nuisance("logistic", "clf", jcfg), key,
                       jargs[3], *jargs[:3], _K)
    folds = convert.folds(jcf.folds, device="cpu")
    monkeypatch.setattr(tiv, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    X, y, t, z = (_t(a) for a in data)
    res = tiv.DRIV(CausalConfig(**kw), device="cpu").fit(y, t, z, X)
    _close(res.theta_pre, jres.theta_pre, "theta_pre")
    _close(res.pseudo.numpy(), np.asarray(jres.pseudo), "psi")
    _close(res.late, jres.late, "LATE")
    _close(res.stderr, jres.stderr, "se")
    _close(res.theta.numpy(), np.asarray(jres.theta), "theta")
    for name, want in jres.diagnostics.rows().items():
        got = getattr(res.diagnostics, name)
        if isinstance(want, bool):
            assert got == want, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    _close(res.late_interval(), jres.late_interval(), "analytic interval")
    assert "DRIV" in res.summary() and "θ_pre" in res.summary()


def _reference_draws(scheme, n_rep):
    """Per-replicate (key, folds, w) of the reference's closure; the fold
    key ``driv_theta_once`` takes is the first of five."""
    out = []
    for kb in jboot.replicate_keys(jax.random.PRNGKey(3), n_rep):
        kw, kfit = jax.random.split(kb)
        w = jboot.bootstrap_weights(kw, _N, scheme)
        folds = jfold_ids(jax.random.split(kfit, 5)[0], _N, _K)
        out.append((kfit, np.asarray(folds), np.asarray(w)))
    return out


def _nuisances(rb):
    cfg = CausalConfig(n_folds=_K, row_block=rb,
                       row_block_strategy="pallas" if rb else "chunked")
    return (make_nuisance("ridge", "reg", cfg),
            make_nuisance("logistic", "clf", cfg),
            make_nuisance("logistic", "clf", cfg),
            make_ridge(cfg.ridge_lambda, row_block=rb,
                       strategy=cfg.row_block_strategy),
            cfg.row_block_strategy)


@pytest.mark.parametrize("rb", [0, _RB])
@pytest.mark.parametrize("scheme", ["pairs", "multiplier"])
def test_driv_theta_once_matches_reference(data, scheme, rb):
    JX, jy, jt, jz = (jnp.asarray(a) for a in data)
    jphi = jnp.concatenate([jnp.ones((_N, 1)), JX[:, :1]], axis=1)
    jcfg = JCausalConfig(n_folds=_K, row_block=rb)
    jny = jmake_nuisance("ridge", "reg", jcfg)
    jnt = jmake_nuisance("logistic", "clf", jcfg)
    jcomp = jmake_ridge(1e-3, row_block=rb)
    draws = _reference_draws(scheme, _B)
    want = [jboot.driv_theta_once(jny, jnt, jnt, jcomp, _K, JX, jy, jt, jz,
                                  jphi, key, jnp.asarray(w), row_block=rb)
            for key, _, w in draws]
    ny, nt, nz, comp, st = _nuisances(rb)
    X, y, t, z = (_t(a) for a in data)
    phi = cate_basis(X, 2)
    folds = torch.from_numpy(np.stack([f for _, f, _ in draws])).long()
    w = torch.from_numpy(np.stack([w for _, _, w in draws]))
    got = boot.driv_theta_once(ny, nt, nz, comp, _K, X, y, t, z, phi, folds,
                               w, row_block=rb, strategy=st)
    for f in ("theta", "se", "ate"):
        _close(got[f].numpy(), np.stack([np.asarray(o[f]) for o in want]), f)
    one = boot.driv_theta_once(ny, nt, nz, comp, _K, X, y, t, z, phi,
                               folds[1], w[1], row_block=rb, strategy=st)
    for f in ("theta", "se", "ate"):
        assert torch.equal(one[f], got[f][1]), f


def test_driv_bootstrap_serial_equals_batched_and_jackknife_raises(data):
    X, y, t, z = (_t(a) for a in data)
    cfg = CausalConfig(n_folds=_K, cate_features=2, row_block=_RB,
                       row_block_strategy="pallas", inference="bootstrap",
                       n_bootstrap=4, runtime_chunk=3)
    res = tiv.DRIV(cfg, device="cpu").fit(y, t, z, X)
    batched = res.inference(executor="vmap")
    serial = res.inference(executor="serial")
    assert batched.n_replicates == 4 and batched.ate_point == res.late
    assert torch.equal(serial.replicates, batched.replicates)
    assert torch.equal(serial.ate_replicates, batched.ate_replicates)
    lo, hi = res.late_interval()
    assert (lo, hi) == batched.late_interval()
    with pytest.raises(ValueError, match="jackknife"):
        res.inference(method="jackknife")


def test_driv_recovers_late_and_registry(data):
    d = make_iv_data(4000, 6, seed=3, device="cpu")
    spec = registry.get_spec("driv")
    cfg = spec.base_cfg
    res = spec.fit(d, cfg, torch.Generator().manual_seed(0))
    assert isinstance(res, tiv.DRIVResult) and spec.point(res) == res.late
    assert abs(res.late - d.true_late) <= 4 * res.stderr
    assert not res.diagnostics.weak_instrument
    ortho = tiv.OrthoIV(cfg, device="cpu").fit(
        d.y, d.t, d.z, d.X, gen=torch.Generator().manual_seed(0))
    assert abs(res.late - ortho.late) <= 4 * res.stderr
    folds = tiv.fold_ids(torch.Generator().manual_seed(1), d.n, cfg.n_folds)
    out = spec.weighted_fit(cfg)(folds, torch.ones(d.n),
                                 {"X": d.X, "y": d.y, "t": d.t, "z": d.z,
                                  "phi": cate_basis(d.X, 1)})
    assert set(out) == {"theta", "se", "ate"}
    assert abs(float(out["ate"]) - d.true_late) <= 4 * res.stderr
