"""The port's tuning (repro_torch.core.tuning, paper §5.2) held against
the JAX package's on the same numpy data and the reference's folds
(handed in by replacing ``tuning.fold_ids``; the halving's shared mlp
init by replacing ``tuning.make_mlp``'s ``init`` with the reference's
draws through ``convert.mlp_state``).

  * ``tune_penalty``: per-trial out-of-fold scores within rtol 1e-4
    plus atol 1e-6 and the same winner, reg and clf, at row_block 0 and
    on the blocked "pallas" path (the kernel's plain version here);
  * ``successive_halving``: every rung's scores (rtol 1e-3: 10–40 AdamW
    steps of an MLP in two frameworks) and survivor sets equal;
  * ``tuned_nuisances`` / ``tuned_iv_nuisances``: the winners' λ equal
    the reference's on its folds, each grid ONE ``map_product``, and
    DML on the winners recovers the effect;
  * the reference's own behaviour checks (noisy targets pick the
    heavy penalty, clean ones the light; halving drops a rate that
    cannot learn);
  * inside torch: a serial run of the grid's cells equals the batched
    one within 1e-6 and picks the same winner; ties keep the earlier
    trial.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core import tuning as jtuning  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.core.nuisance import make_mlp as jmake_mlp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.runtime import TaskRuntime  # noqa: E402

_N, _P = 700, 8
_KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    y = (X @ rng.standard_normal(_P) + rng.standard_normal(_N)
         ).astype(np.float32)
    t = (rng.random(_N) < 1 / (1 + np.exp(-2 * X[:, 0]))).astype(np.float32)
    z = (rng.random(_N) < 0.5).astype(np.float32)
    return X, y, t, z


def _hand_in_folds(monkeypatch, keys, k):
    """The reference's folds of each key, in call order."""
    folds = iter([torch.from_numpy(np.asarray(
        jfold_ids(key, _N, k)).astype(np.int64)) for key in keys])
    monkeypatch.setattr(tuning, "fold_ids",
                        lambda gen, n, k_, device=None: next(folds))


_LAMS = np.array([1e-4, 1e-2, 1.0, 30.0], np.float32)


@pytest.mark.parametrize("rb,st", [(0, None), (256, "pallas")])
@pytest.mark.parametrize("task", ["reg", "clf"])
def test_tune_penalty_matches_reference(data, task, rb, st, monkeypatch):
    X, y, t, _ = data
    target = y if task == "reg" else t
    jr = jtuning.tune_penalty(task, jnp.asarray(_LAMS), jnp.asarray(X),
                              jnp.asarray(target), n_folds=4, key=_KEY)
    _hand_in_folds(monkeypatch, [_KEY], 4)
    res = tuning.tune_penalty(task, _LAMS, X, target, n_folds=4,
                              row_block=rb, strategy=st, device="cpu")
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jr.scores),
                               rtol=1e-4, atol=1e-6)
    assert res.best_index == jr.best_index
    assert res.best_value == pytest.approx(jr.best_value)
    assert res.best_score == pytest.approx(jr.best_score, rel=1e-4)


@pytest.mark.parametrize("task", ["reg", "clf"])
def test_successive_halving_history_matches_reference(data, task,
                                                      monkeypatch):
    X, y, t, _ = data
    target = y if task == "reg" else t
    lrs = np.array([1e-6, 1e-3, 3e-3, 1e-2], np.float32)
    kw = dict(n_folds=2, base_steps=10, eta=2, rungs=2, hidden=(16,))
    jr = jtuning.successive_halving(task, jnp.asarray(lrs), jnp.asarray(X),
                                    jnp.asarray(target), key=_KEY, **kw)
    st0 = jax.tree_util.tree_map(
        np.asarray, jmake_mlp(task, hidden=(16,), steps=10).init(_KEY, _P))
    _hand_in_folds(monkeypatch, [_KEY], 2)
    real = tuning.make_mlp
    monkeypatch.setattr(tuning, "make_mlp", lambda *a, **k: dataclasses.replace(
        real(*a, **k), init=lambda gen, p, device=None: convert.mlp_state(
            st0, device="cpu")))
    res = tuning.successive_halving(task, lrs, X, target, device="cpu", **kw)
    assert len(res.history) == len(jr.history) == 2
    for got, want in zip(res.history, jr.history):
        assert (got["rung"], got["steps"]) == (want["rung"], want["steps"])
        np.testing.assert_allclose(got["lrs"], want["lrs"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-3)
        np.testing.assert_allclose(got["kept"], want["kept"])
    assert res.best_lr == pytest.approx(jr.best_lr)


def _count_products(monkeypatch):
    calls = []
    real = TaskRuntime.map_product

    def counted(self, fn, *a, **k):
        calls.append(k.get("label"))
        return real(self, fn, *a, **k)

    monkeypatch.setattr(TaskRuntime, "map_product", counted)
    return calls


def test_tuned_nuisances_match_reference(data, monkeypatch):
    X, y, t, _ = data
    jcfg, cfg = JCausalConfig(n_folds=3), CausalConfig(n_folds=3)
    jy, jt = jtuning.tuned_nuisances(jcfg, jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(t), _KEY)
    _hand_in_folds(monkeypatch, list(jax.random.split(_KEY)), 3)
    calls = _count_products(monkeypatch)
    ny, nt = tuning.tuned_nuisances(cfg, X, y, t, device="cpu")
    assert calls == ["tune_penalty"] * 2
    assert (ny.name, nt.name) == ("ridge", "logistic")
    assert ny.hyper["lam"] == pytest.approx(jy.hyper["lam"])
    assert nt.hyper["lam"] == pytest.approx(jt.hyper["lam"])
    assert nt.hyper["iters"] == cfg.newton_iters


def test_tuned_iv_nuisances_match_reference(data, monkeypatch):
    X, y, t, z = data
    jcfg, cfg = JCausalConfig(n_folds=3), CausalConfig(n_folds=3)
    jn = jtuning.tuned_iv_nuisances(jcfg, jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(t), jnp.asarray(z), _KEY)
    _hand_in_folds(monkeypatch, list(jax.random.split(_KEY, 3)), 3)
    calls = _count_products(monkeypatch)
    tn = tuning.tuned_iv_nuisances(cfg, X, y, t, z, device="cpu")
    assert calls == ["tune_penalty"] * 3
    for got, want in zip(tn, jn):
        assert got.name == want.name
        assert got.hyper["lam"] == pytest.approx(want.hyper["lam"])


def test_tuned_nuisances_plug_into_dml():
    from repro_torch.data.causal_dgp import make_causal_data
    d = make_causal_data(4000, 10, seed=1, effect=1.0, device="cpu")
    cfg = CausalConfig(n_folds=3)
    ny, nt = tuning.tuned_nuisances(cfg, d.X, d.y, d.t, device="cpu")
    res = DML(cfg, nuisance_y=ny, nuisance_t=nt, device="cpu").fit(
        d.y, d.t, d.X)
    assert abs(res.ate - 1.0) < 0.12


def test_noisy_targets_prefer_heavy_penalty():
    g = torch.Generator().manual_seed(0)
    X = torch.randn((120, 100), generator=g)
    y = torch.randn(120, generator=g)
    res = tuning.tune_penalty("reg", [1e-5, 1e-3, 10.0], X, y, n_folds=4,
                              device="cpu")
    assert res.best_value == 10.0 and tuple(res.scores.shape) == (3,)


def test_clean_targets_prefer_light_penalty():
    g = torch.Generator().manual_seed(1)
    X = torch.randn((2000, 10), generator=g)
    y = X @ torch.randn(10, generator=g) + 0.01 * torch.randn(2000,
                                                               generator=g)
    res = tuning.tune_penalty("reg", [1e-5, 100.0], X, y, n_folds=4,
                              device="cpu")
    assert res.best_value == pytest.approx(1e-5)


def test_halving_drops_a_rate_that_cannot_learn():
    g = torch.Generator().manual_seed(2)
    X = torch.randn((600, 5), generator=g)
    y = X @ torch.randn(5, generator=g)
    res = tuning.successive_halving("reg", [1e-6, 1e-3, 3e-3], X, y,
                                    n_folds=2, base_steps=30, rungs=2,
                                    hidden=(16,), device="cpu")
    assert res.best_lr != pytest.approx(1e-6)
    assert len(res.history[0]["kept"]) <= 2


def test_serial_grid_matches_batched_and_ties_are_stable(data):
    X, y, _, _ = data
    kw = dict(n_folds=3, device="cpu")
    vec = tuning.tune_penalty("reg", _LAMS, X, y, executor="vmap", **kw)
    ser = tuning.tune_penalty("reg", _LAMS, X, y, executor="serial", **kw)
    np.testing.assert_allclose(ser.scores.numpy(), vec.scores.numpy(),
                               rtol=1e-6)
    assert ser.best_index == vec.best_index
    tie = tuning.tune_penalty("reg", [0.5, 0.5, 0.5], X, y, **kw)
    assert tie.best_index == 0
