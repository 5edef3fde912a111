"""The port's bootstrap inference (repro_torch.inference.bootstrap,
executor, intervals) held against the JAX package's.

  * ``bootstrap_weights`` in distribution (pairs: multinomial counts;
    multiplier: Exp(1));
  * replicate lineage inside torch: a B=3 run is a bitwise prefix of a
    B=5 run, and a replicate replayed alone equals its row;
  * ``dml_theta_once`` / ``iv_theta_once`` on the reference's folds and
    weights (taken from ``fold_ids`` / ``bootstrap_weights`` through
    numpy) against the reference's, for pairs and multiplier, at
    row_block 0 and 256 (the port's strategy "pallas": its plain
    version on the CPU);
  * ``DML(device="cpu")`` bootstrap and multiplier intervals against the
    reference's ``InferenceResult`` fed the same replicates;
  * serial ≡ batched ("vmap", microbatch 2) bitwise on the CPU.

Tolerances: replicate thetas and their sandwich se rtol 1e-4 plus an
atol of 1e-4·max|x| (16 fp32 Newton steps per fold and two frameworks'
reassociation; fp32 cross-moments carry ~1e-5 relative error, ROADMAP
§C); intervals over the same replicates rtol 1e-6 (the same quantile
arithmetic in fp32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.nuisance import make_nuisance as jmake_nuisance  # noqa: E402
from repro.inference import bootstrap as jboot  # noqa: E402
from repro.inference.intervals import InferenceResult as JInference  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.final_stage import cate_basis  # noqa: E402
from repro_torch.core.nuisance import make_nuisance  # noqa: E402
from repro_torch.inference import bootstrap as boot  # noqa: E402
from repro_torch.inference.executor import (BatchedExecutor,  # noqa: E402
                                            SerialExecutor, make_executor)

_N, _P, _K, _B, _RB = 1200, 6, 3, 3, 256     # 1200 does not divide 256


def _close(got, want, msg="", rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    prop = 1.0 / (1.0 + np.exp(-X[:, 0]))
    z = (rng.random(_N) < prop).astype(np.float32)
    u = rng.standard_normal(_N).astype(np.float32)
    comp = rng.random(_N) < 0.7
    t = np.where(comp, z, (rng.random(_N) < 1 / (1 + np.exp(-u)))
                 ).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0] + u
         + rng.standard_normal(_N)).astype(np.float32)
    return X, y, t, z


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _reference_draws(scheme, n_rep, n_split):
    """The reference's per-replicate (key, folds, w): its replicate
    closure's split, and the fold key its ``*_residuals_once`` takes
    (the first of ``n_split``)."""
    out = []
    for kb in jboot.replicate_keys(jax.random.PRNGKey(3), n_rep):
        kw, kfit = jax.random.split(kb)
        w = jboot.bootstrap_weights(kw, _N, scheme)
        folds = jfold_ids(jax.random.split(kfit, n_split)[0], _N, _K)
        out.append((kfit, np.asarray(folds), np.asarray(w)))
    return out


def test_bootstrap_weights_in_distribution():
    g = torch.Generator().manual_seed(0)
    n = 4000
    w = boot.bootstrap_weights(g, n, "pairs")
    assert w.dtype == torch.float32 and w.shape == (n,)
    assert float(w.sum()) == n and torch.equal(w, w.round())
    # Binomial(n, 1/n) counts: mean 1, variance 1 - 1/n; P(0) ≈ e^-1
    assert abs(float(w.var()) - 1.0) < 0.1
    assert abs(float((w == 0).float().mean()) - np.exp(-1)) < 0.03
    m = boot.bootstrap_weights(g, n, "multiplier")
    assert bool((m > 0).all())
    assert abs(float(m.mean()) - 1.0) < 0.06      # Exp(1): sd 1/sqrt(n)
    assert abs(float(m.var()) - 1.0) < 0.2
    with pytest.raises(ValueError, match="scheme"):
        boot.bootstrap_weights(g, n, "jackknife")


def _dml_parts(data, rb=0, strategy="chunked"):
    X, y, t, _ = (_t(a) for a in data)
    cfg = CausalConfig(n_folds=_K, cate_features=2, row_block=rb,
                       row_block_strategy=strategy)
    ny = make_nuisance("ridge", "reg", cfg)
    nt = make_nuisance("logistic", "clf", cfg)
    return ny, nt, X, y, t, cate_basis(X, 2)


def test_replicate_prefix_and_replay(data):
    ny, nt, X, y, t, phi = _dml_parts(data)
    kw = dict(n_folds=_K, XW=X, y=y, t=t, phi=phi, seed=42)
    r5 = boot.dml_bootstrap(ny, nt, n_replicates=5, **kw)
    r3 = boot.dml_bootstrap(ny, nt, n_replicates=3, **kw)
    assert torch.equal(r5.replicates[:3], r3.replicates)
    fn = boot.make_dml_replicate_fn(ny, nt, _K, seed=42)
    alone = fn(torch.tensor([4]), X, y, t, phi)
    assert torch.equal(alone["theta"][0], r5.replicates[4])
    gens = boot.replicate_generators(42, 5)
    assert torch.equal(
        boot.bootstrap_weights(gens[4], _N, "pairs"),
        boot.bootstrap_weights(boot.replicate_generator(42, 4), _N, "pairs"))


@pytest.mark.parametrize("rb", [0, _RB])
@pytest.mark.parametrize("scheme", ["pairs", "multiplier"])
@pytest.mark.parametrize("est", ["dml", "iv"])
def test_theta_once_matches_reference(data, est, scheme, rb):
    jcfg = JCausalConfig(n_folds=_K, cate_features=2, row_block=rb)
    jny = jmake_nuisance("ridge", "reg", jcfg)
    jnt = jmake_nuisance("logistic", "clf", jcfg)
    jnz = jmake_nuisance("logistic", "clf", jcfg)
    JX, jy, jt, jz = (jnp.asarray(a) for a in data)
    jphi = jnp.concatenate([jnp.ones((_N, 1)), JX[:, :1]], axis=1)
    draws = _reference_draws(scheme, _B, 3 if est == "dml" else 4)
    want = []
    for key, _, w in draws:
        if est == "dml":
            o = jboot.dml_theta_once(jny, jnt, _K, JX, jy, jt, jphi, key,
                                     jnp.asarray(w), row_block=rb)
        else:
            o = jboot.iv_theta_once(jny, jnt, jnz, _K, JX, jy, jt, jz, jphi,
                                    key, jnp.asarray(w), row_block=rb)
        want.append((np.asarray(o["theta"]), np.asarray(o["se"])))

    ny, nt, X, y, t, phi = _dml_parts(data, rb, "pallas" if rb else "chunked")
    folds = torch.from_numpy(np.stack([f for _, f, _ in draws])).long()
    w = torch.from_numpy(np.stack([w for _, _, w in draws]))
    if est == "dml":
        got = boot.dml_theta_once(ny, nt, _K, X, y, t, phi, folds, w,
                                  row_block=rb, strategy=ny.hyper["strategy"])
    else:
        got = boot.iv_theta_once(ny, nt, nt, _K, X, y, t, _t(data[3]), phi,
                                 folds, w, row_block=rb,
                                 strategy=ny.hyper["strategy"])
    _close(got["theta"].numpy(), np.stack([a for a, _ in want]), "theta")
    _close(got["se"].numpy(), np.stack([b for _, b in want]), "se")
    # one replicate alone, unbatched, is the same
    one = (boot.dml_theta_once(ny, nt, _K, X, y, t, phi, folds[1], w[1],
                               row_block=rb, strategy=ny.hyper["strategy"])
           if est == "dml" else
           boot.iv_theta_once(ny, nt, nt, _K, X, y, t, _t(data[3]), phi,
                              folds[1], w[1], row_block=rb,
                              strategy=ny.hyper["strategy"]))
    assert torch.equal(one["theta"], got["theta"][1])


@pytest.mark.parametrize("method", ["bootstrap", "multiplier"])
def test_dml_intervals_match_reference(data, method):
    X, y, t, _ = (_t(a) for a in data)
    cfg = CausalConfig(n_folds=_K, cate_features=2, inference=method,
                       n_bootstrap=6, runtime_chunk=4)
    res = DML(cfg, device="cpu").fit(y, t, X)
    inf = res.inference()
    assert inf.method == ("pairs" if method == "bootstrap" else method)
    assert inf.n_replicates == 6 and inf.executor == "vmap"
    ref = JInference(method=inf.method, executor="vmap",
                     point=jnp.asarray(inf.point.numpy()),
                     replicates=jnp.asarray(inf.replicates.numpy()),
                     se=jnp.asarray(inf.se.numpy()), alpha=cfg.alpha,
                     point_se=jnp.asarray(inf.point_se.numpy()),
                     replicate_se=jnp.asarray(inf.replicate_se.numpy()))
    _close(inf.se.numpy(),
           np.asarray(jnp.std(ref.replicates, axis=0, ddof=1)), "se", 1e-6)
    for kind in ("percentile", "normal", "studentized"):
        for a in (0.05, 0.2):
            got, want = inf.interval(a, kind), ref.interval(a, kind)
            for g_, w_ in zip(got, want):
                _close(g_.numpy(), np.asarray(w_), f"{kind} {a}", 1e-6)
            _close(inf.ate_interval(a, kind), ref.ate_interval(a, kind),
                   f"ate {kind} {a}", 1e-6)
    assert res.ate_interval() == inf.ate_interval()
    assert res.late_interval() == res.ate_interval()
    band = res.cate_interval(X[:5])
    jband = ref.cate_interval(jnp.asarray(cate_basis(X[:5], 2).numpy()))
    for g_, w_ in zip(band, jband):
        _close(g_.numpy(), np.asarray(w_), "CATE band", 1e-6)


@pytest.mark.parametrize("est", ["dml", "iv"])
def test_serial_equals_batched_bitwise_on_cpu(data, est):
    ny, nt, X, y, t, phi = _dml_parts(data, _RB, "pallas")
    z = _t(data[3])
    out = {}
    for exe in (SerialExecutor(), BatchedExecutor(microbatch=2), "vmap"):
        if est == "dml":
            r = boot.dml_bootstrap(ny, nt, n_folds=_K, XW=X, y=y, t=t,
                                   phi=phi, seed=7, n_replicates=4,
                                   executor=exe, row_block=_RB,
                                   strategy="pallas")
        else:
            r = boot.iv_bootstrap(ny, nt, nt, n_folds=_K, XW=X, y=y, t=t,
                                  z=z, phi=phi, seed=7, n_replicates=4,
                                  scheme="multiplier", executor=exe,
                                  row_block=_RB, strategy="pallas")
        out[str(exe)] = r
    runs = list(out.values())
    for r in runs[1:]:
        assert torch.equal(r.replicates, runs[0].replicates)
        assert torch.equal(r.replicate_se, runs[0].replicate_se)


def test_executor_factory_and_refusals(data):
    assert isinstance(make_executor("serial"), SerialExecutor)
    exe = make_executor("vmap", microbatch=3)
    assert isinstance(exe, BatchedExecutor) and exe.microbatch == 3
    assert make_executor(exe) is exe
    with pytest.raises(ValueError, match="DataMesh"):
        make_executor("shard_map")      # no mesh given, none active
    with pytest.raises(ValueError, match="executor"):
        make_executor("ray")
    # a memory budget goes to the task runtime: on the CPU torch keeps no
    # peak counter, so the map runs as one chunk, bitwise the unbudgeted
    ny, nt, X, y, t, phi = _dml_parts(data)
    kw = dict(n_folds=_K, XW=X, y=y, t=t, phi=phi, seed=0, n_replicates=2)
    budgeted = boot.dml_bootstrap(ny, nt, memory_budget=1 << 30, **kw)
    assert torch.equal(budgeted.replicates,
                       boot.dml_bootstrap(ny, nt, **kw).replicates)
