"""The port's S/T/X metalearners (repro_torch.core.metalearners) held
against the JAX package's on the same numpy data.

  * the weighted cores' ATE and pointwise CATE at w = 1 and at
    exponential weights, row_block 0 and 256 (1100 rows: a ragged last
    block), "chunked" and "pallas" (the kernel's plain version on the
    CPU): rtol 1e-4 plus atol 1e-5·max|x| (fp32 Grams in another order;
    ROADMAP §C);
  * ``meta_bootstrap`` on the reference's draws — replicate b's weights
    from ``split(replicate_keys(key, B)[b])[0]`` through its
    ``bootstrap_weights``, handed in by replacing
    ``metalearners.replicate_weights`` — for pairs and multiplier: the
    ATE draws, se and both interval kinds;
  * inside torch, bitwise: serial ≡ batched replicates, chunked ≡ one
    call, a replicate alone ≡ its row, B = 3 a prefix of B = 5, a batched
    core ≡ each weight row alone (with the X-learner's per-replicate
    stage-2 fits);
  * ``MetaResult``: "jackknife" runs the bootstrap, ``cate_interval``
    refuses, the summary quotes only a computed CI;
  * ``estimands.ate_from_cate`` / ``att_from_cate``; a custom (mlp)
    nuisance runs through ``nuis.fit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core import estimands as jest  # noqa: E402
from repro.core import metalearners as jmeta  # noqa: E402
from repro.inference import bootstrap as jboot  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import estimands  # noqa: E402
from repro_torch.core import metalearners as meta  # noqa: E402
from repro_torch.core.nuisance import make_mlp  # noqa: E402

_N, _P, _RB = 1100, 6, 256
_KEY = jax.random.PRNGKey(9)


def _close(got, want, msg="", rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    t = (rng.random(_N) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0] - 0.3 * X[:, 2]
         + rng.standard_normal(_N)).astype(np.float32)
    w = rng.exponential(size=(3, _N)).astype(np.float32)
    return X, y, t, w


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(rb, st):
    kw = dict(n_folds=3, row_block=rb)
    return (JCausalConfig(**kw),
            CausalConfig(**kw, row_block_strategy=st))


@pytest.mark.parametrize("learner", ["s", "t", "x"])
@pytest.mark.parametrize("rb,st", [(0, "chunked"), (_RB, "chunked"),
                                   (_RB, "pallas")])
def test_cores_match_reference(data, learner, rb, st):
    X, y, t, w = data
    jcfg, tcfg = _cfgs(rb, st)
    jcore = jmeta.make_meta_core(learner, jcfg)
    core = meta.make_meta_core(learner, tcfg)
    for wb in (np.ones(_N, np.float32), w[0]):
        jate, jcate = jcore(_KEY, jnp.asarray(y), jnp.asarray(t),
                            jnp.asarray(X), jnp.asarray(wb))
        ate, cate = core(None, _t(y), _t(t), _t(X), _t(wb))
        _close(cate.numpy(), np.asarray(jcate), f"{learner} cate")
        _close(float(ate), float(jate), f"{learner} ate")


@pytest.mark.parametrize("learner", ["s", "t", "x"])
def test_public_fits_match_reference(data, learner):
    X, y, t, _ = data
    fn = {"s": meta.s_learner, "t": meta.t_learner, "x": meta.x_learner}
    jfn = {"s": jmeta.s_learner, "t": jmeta.t_learner, "x": jmeta.x_learner}
    jres = jfn[learner](jnp.asarray(y), jnp.asarray(t), jnp.asarray(X),
                        key=_KEY)
    res = fn[learner](y, t, X, device="cpu")
    assert isinstance(res, meta.MetaResult) and res.learner == learner
    _close(res.cate.numpy(), np.asarray(jres.cate), "cate")
    _close(res.ate, jres.ate, "ate")


@pytest.mark.parametrize("learner", ["s", "t", "x"])
def test_batched_core_bitwise_each_row_alone(data, learner):
    X, y, t, w = data
    core = meta.make_meta_core(learner, CausalConfig(
        row_block=_RB, row_block_strategy="pallas"))
    ate, cate = core(None, _t(y), _t(t), _t(X), _t(w))
    assert tuple(ate.shape) == (3,) and tuple(cate.shape) == (3, _N)
    for b in range(3):
        a1, c1 = core(None, _t(y), _t(t), _t(X), _t(w[b:b + 1]))
        assert torch.equal(a1[0], ate[b]) and torch.equal(c1[0], cate[b])


def _ref_weights(key, B, n, scheme):
    ws = []
    for kb in jboot.replicate_keys(key, B):
        kw, _ = jax.random.split(kb)
        ws.append(np.asarray(jboot.bootstrap_weights(kw, n, scheme)))
    return np.stack(ws)


@pytest.mark.parametrize("scheme", ["pairs", "multiplier"])
@pytest.mark.parametrize("learner", ["t", "x"])
def test_meta_bootstrap_on_reference_draws(data, learner, scheme,
                                           monkeypatch):
    X, y, t, _ = data
    B = 4
    jcore = jmeta.make_meta_core(learner, JCausalConfig(n_folds=3))
    jinf = jmeta.meta_bootstrap(jcore, y=jnp.asarray(y), t=jnp.asarray(t),
                                X=jnp.asarray(X), key=_KEY, n_replicates=B,
                                scheme=scheme, ate_point=0.9)
    W = torch.from_numpy(_ref_weights(_KEY, B, _N, scheme))
    monkeypatch.setattr(meta, "replicate_weights",
                        lambda seed, ids, n, sch, device=None:
                        (W[ids].to(device), None))
    core = meta.make_meta_core(learner, CausalConfig(n_folds=3))
    inf = meta.meta_bootstrap(core, y=_t(y), t=_t(t), X=_t(X), seed=0,
                              n_replicates=B, scheme=scheme, ate_point=0.9)
    _close(inf.ate_replicates.numpy(), np.asarray(jinf.ate_replicates),
           "draws")
    _close(inf.se.numpy(), np.asarray(jinf.se), "se", rtol=1e-3)
    for kind in ("percentile", "normal"):
        _close(inf.ate_interval(0.1, kind), jinf.ate_interval(0.1, kind),
               kind)
    assert tuple(inf.replicates.shape) == (B, 1)


def test_meta_bootstrap_serial_equals_batched(data):
    X, y, t, _ = data
    core = meta.make_meta_core("x", CausalConfig(
        n_folds=3, row_block=_RB, row_block_strategy="pallas"))
    kw = dict(y=_t(y), t=_t(t), X=_t(X), seed=11, scheme="pairs")
    ser = meta.meta_bootstrap(core, n_replicates=5, executor="serial", **kw)
    vec = meta.meta_bootstrap(core, n_replicates=5, executor="vmap", **kw)
    chunked = meta.meta_bootstrap(core, n_replicates=5, chunk=2, **kw)
    prefix = meta.meta_bootstrap(core, n_replicates=3, **kw)
    assert torch.equal(ser.ate_replicates, vec.ate_replicates)
    assert torch.equal(chunked.ate_replicates, vec.ate_replicates)
    assert torch.equal(prefix.ate_replicates, vec.ate_replicates[:3])
    w, gens = meta.replicate_weights(11, torch.tensor([2]), _N, "pairs")
    alone, _ = core(gens, _t(y), _t(t), _t(X), w)
    assert torch.equal(alone[0], vec.ate_replicates[2])


def test_meta_bootstrap_mlp_inits_per_replicate(data):
    """With an mlp nuisance, replicate b's models draw their inits on
    its own generator after its weights: batched ≡ serial ≡ the
    replicate alone, bitwise, and not the seed-0 init of a core called
    without generators."""
    X, y, t, _ = data
    core = meta.make_meta_core("t", CausalConfig(), nuisance=make_mlp(
        "reg", hidden=(4,), steps=3, lr=1e-2))
    kw = dict(y=_t(y), t=_t(t), X=_t(X), seed=4, n_replicates=3)
    vec = meta.meta_bootstrap(core, executor="vmap", **kw)
    ser = meta.meta_bootstrap(core, executor="serial", **kw)
    assert torch.equal(ser.ate_replicates, vec.ate_replicates)
    w, gens = meta.replicate_weights(4, torch.tensor([1]), _N, "pairs")
    alone, _ = core(gens, _t(y), _t(t), _t(X), w)
    assert torch.equal(alone[0], vec.ate_replicates[1])
    seeded, _ = core(None, _t(y), _t(t), _t(X), w)
    assert not torch.equal(seeded[0], vec.ate_replicates[1])


def test_meta_result_inference_surface(data):
    X, y, t, _ = data
    cfg = CausalConfig(n_folds=3, inference="jackknife", n_bootstrap=6)
    res = meta.t_learner(y, t, X, cfg=cfg, device="cpu")
    assert "CI" not in res.summary()
    lo, hi = res.ate_interval()
    assert lo < res.ate < hi
    inf = res.inference()
    assert inf.method == "pairs" and inf.ate_point == res.ate
    assert "CI" in res.summary()
    with pytest.raises(ValueError, match="phi basis"):
        res.cate_interval(X)
    with pytest.raises(ValueError, match="unknown metalearner"):
        meta.make_meta_core("q")


def test_ate_att_from_cate_match_reference(data):
    _, _, t, w = data
    cate = w[0] - 1.0
    assert estimands.ate_from_cate(_t(cate)) == pytest.approx(
        jest.ate_from_cate(jnp.asarray(cate)), rel=1e-6)
    assert estimands.att_from_cate(_t(cate), _t(t)) == pytest.approx(
        jest.att_from_cate(jnp.asarray(cate), jnp.asarray(t)), rel=1e-6)


def test_custom_nuisance_runs_through_fit(data):
    X, y, t, w = data
    nuis = make_mlp("reg", hidden=(8,), steps=5)
    core = meta.make_meta_core("t", CausalConfig(), nuisance=nuis)
    gens = [torch.Generator().manual_seed(j) for j in range(2)]
    ate, cate = core(gens, _t(y), _t(t), _t(X), _t(w[:2]))
    assert tuple(ate.shape) == (2,) and bool(torch.isfinite(cate).all())
    res = meta.x_learner(y, t, X, nuisance=nuis, device="cpu")
    assert np.isfinite(res.ate)
