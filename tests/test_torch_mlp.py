"""The port's mlp nuisance (``repro_torch.core.nuisance.make_mlp``) held
against the JAX package's, from the same weights.

torch cannot replay ``jax.random.normal``: the reference's ``init``
draws (``_mlp_init``) cross over as numpy through ``convert.mlp_state``.

  * the fit (reg and clf, weighted) and its predictions — the forward
    with GELU's tanh form, the clf log-loss, the AdamW steps with
    b2 = 0.95 — within rtol 1e-4 plus atol 1e-5·max|pred| (30 full-batch
    fp32 steps in two frameworks);
  * an ``"lr"`` state leaf overrides the baked-in rate, as in the
    reference;
  * the weighted refit of the bootstrap (``fit_predict_folds``) against
    the reference's own, each fold model from the reference's draw on
    that fold's key;
  * the refits' inits: each (replicate, fold) model its own, drawn on
    the replicate's generator alone, so the mlp bootstrap is bitwise
    the same serial, batched and chunked;
  * ``DML.fit`` with mlp outcome and treatment nuisances on the
    reference's folds and per-fold inits (``fold_ids`` and the
    nuisances' ``init`` handed in): θ within rtol 1e-4 + atol 1e-4;
  * inside torch, bitwise: a batched fit (k fold models in one fit) ≡
    each model fitted alone, an unbatched state copied to a batch, and
    the "parallel" cross-fit ≡ the "sequential" one;
  * ``make_nuisance("mlp")`` and ``convert.mlp_state`` with a batch axis;
  * the reference's mlp defaults overfit many noise columns (saturated
    propensities, theta far from the truth) in both packages alike.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.crossfit import fold_weights as jfold_weights  # noqa: E402
from repro.core.dml import DML as JDML  # noqa: E402
from repro.core.nuisance import make_mlp as jmake_mlp  # noqa: E402
from repro.inference import bootstrap as jboot  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
# the submodule, not the ``crossfit`` function ``repro_torch.core`` re-exports
tcf = importlib.import_module("repro_torch.core.crossfit")
from repro_torch.core.crossfit import fold_weights  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.nuisance import make_mlp, make_nuisance  # noqa: E402
from repro_torch.inference import bootstrap as tboot  # noqa: E402
from repro_torch.inference.bootstrap import fit_predict_folds  # noqa: E402

_N, _P, _K, _HID, _STEPS = 500, 6, 3, (16, 8), 30


def _close(got, want, msg="", rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    t = (rng.random(_N) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = (t + np.sin(X[:, 0]) + 0.5 * X[:, 1] ** 2
         + 0.5 * rng.standard_normal(_N)).astype(np.float32)
    w = rng.exponential(size=_N).astype(np.float32)
    return X, y, t, w


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_init(nuis, states):
    """``nuis`` whose ``init`` hands out the given port states in turn."""
    it = iter(states)
    return dataclasses.replace(nuis, init=lambda gen, p, device=None:
                               next(it))


@pytest.mark.parametrize("task", ["reg", "clf"])
def test_fit_matches_reference_from_same_init(data, task):
    X, y, t, w = data
    target = y if task == "reg" else t
    jn = jmake_mlp(task, hidden=_HID, steps=_STEPS, lr=3e-3)
    st0 = jn.init(jax.random.PRNGKey(1), _P)
    jst = jn.fit(st0, jnp.asarray(X), jnp.asarray(target), jnp.asarray(w))
    jpred = np.asarray(jn.predict(jst, jnp.asarray(X)))
    tn = make_mlp(task, hidden=_HID, steps=_STEPS, lr=3e-3)
    tst = tn.fit(convert.mlp_state(_np_tree(st0), device="cpu"), _t(X),
                 _t(target), _t(w))
    _close(tn.predict(tst, _t(X)).numpy(), jpred, f"{task} predictions")
    for key in jst["params"]:
        _close(tst["params"][key].numpy(), np.asarray(jst["params"][key]),
               key, atol_rel=1e-4)
    assert int(tst["opt"]["step"]) == _STEPS == int(jst["opt"].step)
    if task == "clf":
        p = tn.predict(tst, _t(X))
        assert bool(((p > 0) & (p < 1)).all())


def test_lr_state_leaf_overrides_rate(data):
    X, y, _, w = data
    jn = jmake_mlp("reg", hidden=_HID, steps=10, lr=1e-3)
    st0 = jn.init(jax.random.PRNGKey(2), _P)
    jst = jn.fit({**st0, "lr": jnp.float32(2e-2)}, jnp.asarray(X),
                 jnp.asarray(y), jnp.asarray(w))
    tn = make_mlp("reg", hidden=_HID, steps=10, lr=1e-3)
    tst0 = convert.mlp_state(_np_tree(st0), device="cpu")
    tst = tn.fit({**tst0, "lr": torch.tensor(2e-2)}, _t(X), _t(y), _t(w))
    _close(tn.predict(tst, _t(X)).numpy(),
           np.asarray(jn.predict(jst, jnp.asarray(X))), "lr leaf")
    base = tn.fit(tst0, _t(X), _t(y), _t(w))
    assert not torch.equal(base["params"]["w0"], tst["params"]["w0"])


def test_gelu_is_the_tanh_form(data):
    """Predictions from the init state are the forward alone: the
    port's against the reference's on the same weights (torch's default
    GELU, the erf form, parts from it by up to 5e-4 an activation)."""
    X = data[0]
    jn = jmake_mlp("reg", hidden=_HID, steps=1)
    st0 = jn.init(jax.random.PRNGKey(3), _P)
    want = np.asarray(jn.predict(st0, jnp.asarray(X)))
    got = make_mlp("reg", hidden=_HID, steps=1).predict(
        convert.mlp_state(_np_tree(st0), device="cpu"), _t(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weighted_refit_matches_reference(data):
    """The bootstrap's weighted mlp refit: each fold model of a (k, n)
    weight batch from its own init — the reference's draw on that fold's
    key (``split(key, k)``), handed in through ``init`` in fold order —
    against the reference's ``fit_predict_folds`` on that key."""
    X, y, _, w = data
    folds = np.asarray(jfold_ids(jax.random.PRNGKey(4), _N, _K))
    Wk = np.asarray(jfold_weights(jnp.asarray(folds), _K)) * w[None]
    jn = jmake_mlp("reg", hidden=_HID, steps=20, lr=3e-3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jboot.fit_predict_folds(jn, key, jnp.asarray(X),
                                              jnp.asarray(y),
                                              jnp.asarray(Wk)))
    sts = jax.vmap(jn.init, in_axes=(0, None))(jax.random.split(key, _K),
                                               _P)
    batch = convert.mlp_state(_np_tree(sts), device="cpu")
    assert not np.array_equal(np.asarray(sts["params"]["w0"][0]),
                              np.asarray(sts["params"]["w0"][1]))
    tn = _with_init(make_mlp("reg", hidden=_HID, steps=20, lr=3e-3),
                    [jax.tree_util.tree_map(lambda a, j=j: a[j], batch)
                     for j in range(_K)])
    got = fit_predict_folds(tn, _t(X), _t(y), _t(Wk), [torch.Generator()])
    assert tuple(got.shape) == (_K, _N)
    _close(got.numpy(), want, "weighted refit")


def test_refit_inits_each_replicate_and_fold_its_own():
    """``init_states``: every (replicate, fold) model of a refit batch
    starts from its own draw, row r's on its replicate's generator alone
    — the same draws as that row in a batch of one."""
    n = make_mlp("reg", hidden=(4,), steps=1)
    gens = [tboot.replicate_generator(3, b) for b in range(2)]
    st = tboot.init_states(n, gens, 2, _K, _P, "cpu")
    w0 = st["params"]["w0"]
    assert tuple(w0.shape) == (2 * _K, _P, 4)
    assert len({tuple(m.reshape(-1).tolist()) for m in w0}) == 2 * _K
    alone = tboot.init_states(n, [tboot.replicate_generator(3, 1)], 1, _K,
                              _P, "cpu")
    assert torch.equal(alone["params"]["w0"], w0[_K:])
    seeded = tboot.init_states(n, None, 2, _K, _P, "cpu")["params"]["w0"]
    assert torch.equal(seeded[:_K], seeded[_K:])
    with pytest.raises(ValueError, match="generators"):
        tboot.init_states(n, gens, 3, _K, _P, "cpu")
    with pytest.raises(ValueError, match="generators"):
        tboot.init_states(n, gens[0], 2, _K, _P, "cpu")


def test_mlp_bootstrap_serial_batched_chunked_bitwise(data):
    """``dml_bootstrap`` with mlp nuisances: each replicate's fold inits
    come from its own generator, so its draws are bitwise the same
    serial, batched, chunked and replayed alone, and two replicates'
    inits differ."""
    X, y, t, _ = data
    ny, nt = (make_mlp(task, hidden=(4,), steps=3, lr=1e-2)
              for task in ("reg", "clf"))
    phi = torch.ones((_N, 1))
    kw = dict(n_folds=_K, XW=_t(X), y=_t(y), t=_t(t), phi=phi, seed=5,
              n_replicates=3)
    vec = tboot.dml_bootstrap(ny, nt, executor="vmap", **kw)
    ser = tboot.dml_bootstrap(ny, nt, executor="serial", **kw)
    chunked = tboot.dml_bootstrap(ny, nt, chunk=2, **kw)
    assert torch.equal(ser.replicates, vec.replicates)
    assert torch.equal(chunked.replicates, vec.replicates)
    folds, w, gens = tboot.replicate_draws(5, torch.tensor([2]), _N, _K,
                                           "pairs")
    alone = tboot.dml_theta_once(ny, nt, _K, _t(X), _t(y), _t(t), phi,
                                 folds, w, gens=gens)
    assert torch.equal(alone["theta"][0], vec.replicates[2])
    # a replicate's refit starts from its own draws, not a shared init
    seeded = tboot.dml_theta_once(ny, nt, _K, _t(X), _t(y), _t(t), phi,
                                  folds, w)
    assert not torch.equal(seeded["theta"][0], vec.replicates[2])


def test_dml_with_mlp_nuisances_matches_reference(data, monkeypatch):
    X, y, t, _ = data
    kw = dict(n_folds=_K, nuisance_y="mlp", nuisance_t="mlp",
              mlp_hidden=_HID, mlp_steps=_STEPS, mlp_lr=3e-3,
              inference="none")
    key = jax.random.PRNGKey(7)
    jres = JDML(JCausalConfig(**kw)).fit(jnp.asarray(y), jnp.asarray(t),
                                         jnp.asarray(X), key=key)
    kf, ky, kt = jax.random.split(key, 3)
    folds = convert.folds(jres.crossfit.folds, device="cpu")
    est = DML(CausalConfig(**kw), device="cpu")
    inits = []
    for nuis, k in ((est.nuis_y, ky), (est.nuis_t, kt)):
        jn = jmake_mlp(nuis.task, hidden=_HID, steps=_STEPS, lr=3e-3)
        sts = jax.vmap(jn.init, in_axes=(0, None))(jax.random.split(k, _K),
                                                   _P)
        batch = convert.mlp_state(_np_tree(sts), device="cpu")
        inits.append([jax.tree_util.tree_map(lambda a, j=j: a[j], batch)
                      for j in range(_K)])
    est.nuis_y = _with_init(est.nuis_y, inits[0])
    est.nuis_t = _with_init(est.nuis_t, inits[1])
    monkeypatch.setattr(tcf, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    res = est.fit(_t(y), _t(t), _t(X))
    _close(res.crossfit.oof_y.numpy(), np.asarray(jres.crossfit.oof_y),
           "oof y")
    _close(res.crossfit.oof_t.numpy(), np.asarray(jres.crossfit.oof_t),
           "oof t")
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                               rtol=1e-4, atol=1e-4)


def test_batched_fit_bitwise_each_model_alone(data):
    X, y, _, w = data
    n = make_mlp("reg", hidden=_HID, steps=12, lr=3e-3)
    folds = tcf.fold_ids(torch.Generator().manual_seed(0), _N, _K)
    W = fold_weights(folds, _K) * _t(w)[None]
    gens = [torch.Generator().manual_seed(10 + j) for j in range(_K)]
    states = [n.init(g, _P) for g in gens]
    batch = tcf._stack_states(states)
    assert tuple(batch["opt"]["step"].shape) == (_K,)
    fitted = n.fit(batch, _t(X), _t(y), W)
    preds = n.predict(fitted, _t(X))
    for j in range(_K):
        alone = n.fit(states[j], _t(X), _t(y), W[j])
        assert torch.equal(n.predict(alone, _t(X)), preds[j]), j
        for key in alone["params"]:
            assert torch.equal(alone["params"][key],
                               fitted["params"][key][j]), key
    # an unbatched state under batched weights: copied to every model
    shared = n.fit(states[0], _t(X), _t(y), W)
    assert torch.equal(n.predict(shared, _t(X))[0], preds[0])


def test_make_nuisance_and_batched_convert():
    cfg = CausalConfig(nuisance_y="mlp", nuisance_t="mlp", mlp_hidden=(8,),
                       mlp_steps=3, mlp_lr=1e-2)
    ny, nt = make_nuisance("mlp", "reg", cfg), make_nuisance("mlp", "clf",
                                                             cfg)
    assert (ny.name, nt.name, nt.task) == ("mlp_reg", "mlp_clf", "clf")
    assert ny.hyper == {"hidden": (8,), "steps": 3, "lr": 1e-2}
    jn = jmake_mlp("reg", hidden=(8,), steps=3)
    sts = jax.vmap(jn.init, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(0), 4), 5)
    st = convert.mlp_state(_np_tree(sts), device="cpu")
    assert tuple(st["params"]["w0"].shape) == (4, 5, 8)
    assert tuple(st["opt"]["step"].shape) == (4,)
    bare = convert.mlp_state({"params": _np_tree(sts["params"])},
                             device="cpu")
    assert tuple(bare["opt"]["step"].shape) == (4,)
    assert torch.equal(bare["opt"]["m"]["w0"], torch.zeros(4, 5, 8))


def test_parallel_crossfit_bitwise_sequential(data):
    """The mlp's fold fits are batch-invariant, so the "parallel" engine
    (k models in one fit) is bitwise the "sequential" one (one fold at
    a time) — unlike the linear nuisances' one-fold matmuls."""
    X, y, _, _ = data
    n = make_mlp("reg", hidden=(8,), steps=6, lr=1e-2)
    folds = tcf.fold_ids(torch.Generator().manual_seed(1), _N, _K)
    par, st_p = tcf.crossfit_one(n, torch.Generator().manual_seed(2), _t(X),
                                 _t(y), folds, _K, engine="parallel")
    seq, st_s = tcf.crossfit_one(n, torch.Generator().manual_seed(2), _t(X),
                                 _t(y), folds, _K, engine="sequential")
    assert torch.equal(par, seq)
    assert torch.equal(st_p["params"]["w0"], st_s["params"]["w0"])


def test_default_mlp_overfits_noise_columns_like_reference(monkeypatch):
    """At the reference's mlp defaults (200 full-batch AdamW steps at lr
    1e-3, no early stopping) on data with many noise columns, the
    nuisances overfit: the out-of-fold propensity saturates at 0 / 1 and
    DML's theta lands far from the truth — in the reference as in the
    port, which agree to rtol 1e-4.  This is why the card's mlp:dml
    phase holds theta to the CPU's and not to the truth."""
    n, p, k, hid = 3000, 200, 3, (32, 32)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, p)).astype(np.float32)
    t = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0]
         + rng.standard_normal(n)).astype(np.float32)
    kw = dict(n_folds=k, nuisance_y="mlp", nuisance_t="mlp", mlp_hidden=hid,
              cate_features=2, inference="none")
    key = jax.random.PRNGKey(0)
    jres = JDML(JCausalConfig(**kw)).fit(jnp.asarray(y), jnp.asarray(t),
                                         jnp.asarray(X), key=key)
    _, ky, kt = jax.random.split(key, 3)
    folds = convert.folds(jres.crossfit.folds, device="cpu")
    est = DML(CausalConfig(**kw), device="cpu")
    for attr, kk in (("nuis_y", ky), ("nuis_t", kt)):
        nuis = getattr(est, attr)
        jn = jmake_mlp(nuis.task, hidden=hid)
        sts = jax.vmap(jn.init, in_axes=(0, None))(jax.random.split(kk, k), p)
        batch = convert.mlp_state(_np_tree(sts), device="cpu")
        setattr(est, attr, _with_init(nuis, [
            jax.tree_util.tree_map(lambda a, j=j: a[j], batch)
            for j in range(k)]))
    monkeypatch.setattr(tcf, "fold_ids",
                        lambda gen, n_, k_, device=None: folds.to(device))
    res = est.fit(_t(y), _t(t), _t(X))
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                               rtol=1e-4, atol=1e-5)
    for r in (res.diagnostics, jres.diagnostics):
        assert r.min_propensity < 1e-6 and r.max_propensity > 1 - 1e-6
    z = abs(float(res.theta[1]) - 0.5) / float(res.stderr[1])
    assert z > 5.0
