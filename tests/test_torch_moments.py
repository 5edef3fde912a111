"""The port's streaming moments (repro_torch.core.moments) held against
``repro.core.moments``, and its own bitwise contract.

  * each form of the slice against the reference at row_block 0 and 512
    (strategies chunked and pallas; the reference's pallas strategy runs
    the Pallas kernel in interpret mode), including the fold-batched
    weights of the "parallel" engine against a per-fold loop of the
    reference;
  * chunked ≡ whole bitwise inside torch for equal row_block, including
    a row count that does not divide the block;
  * the fallback counter: a form without a fused builder is counted,
    the main-path forms are not.

Tolerance: rtol 1e-5 plus atol 1e-5·max|G| (fp32 reassociation across
frameworks; ROADMAP §C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import moments as jm  # noqa: E402
from repro.kernels.seg_gram import ops as jsg_ops  # noqa: E402
from repro_torch.core import moments as tm  # noqa: E402

_N, _P, _K, _RB = 1100, 5, 5, 512


def _close(got, want, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    f32 = np.float32
    n = _N
    d = dict(
        X=rng.standard_normal((n, _P)).astype(f32),
        y=rng.standard_normal(n).astype(f32),
        t=(rng.random(n) < 0.4).astype(f32),
        my=(0.2 * rng.standard_normal(n)).astype(f32),
        mt=rng.uniform(0.2, 0.8, n).astype(f32),
        w=rng.exponential(size=n).astype(f32),
        v=rng.standard_normal(n).astype(f32),
        folds=rng.integers(0, _K, n).astype(np.int32),
        W=(rng.random((_K, n)) < 0.8).astype(f32),
        theta=np.array([1.0, 0.5], f32),
    )
    d["phi"] = np.concatenate([np.ones((n, 1), f32), d["X"][:, :1]], 1)
    return d


def _forms(lib, d, rb, st):
    """Every slice form on library ``lib`` (jm or tm) over arrays ``d``."""
    kw = dict(row_block=rb, strategy=st)
    return {
        "weighted_gram": lib.weighted_gram(d["X"], d["w"], intercept=True,
                                           append=d["y"], **kw),
        "weighted_gram_plain": lib.weighted_gram(d["X"], d["w"], **kw),
        "weighted_gram_and_vec": lib.weighted_gram_and_vec(
            d["X"], d["w"], d["v"], intercept=True, **kw),
        "fold_gram": lib.fold_gram(d["X"], d["folds"], _K, intercept=True,
                                   append=d["y"], **kw),
        "residual_moments": lib.residual_moments(
            d["y"], d["t"], d["my"], d["mt"], d["phi"], **kw),
        "residual_meat": lib.residual_meat(
            d["y"], d["t"], d["my"], d["mt"], d["phi"], d["theta"], **kw),
        "residual_meat_w": lib.residual_meat(
            d["y"], d["t"], d["my"], d["mt"], d["phi"], d["theta"],
            w=d["w"], **kw),
    }


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("rb,st", [(0, None), (_RB, "chunked"),
                                   (_RB, "pallas")])
def test_forms_match_reference(data, rb, st):
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    td["folds"] = td["folds"].long()
    with jsg_ops.force_backend("interpret"):
        want = _forms(jm, jd, rb, st)
    got = _forms(tm, td, rb, st)
    for name in want:
        for i, (g, w) in enumerate(zip(_leaves(got[name]),
                                       _leaves(want[name]))):
            assert tuple(g.shape) == tuple(w.shape), (name, i)
            _close(g.numpy(), np.asarray(w), f"{name}[{i}] rb={rb} {st}")


@pytest.mark.parametrize("rb,st", [(0, None), (_RB, "pallas")])
def test_fold_batched_weights_match_per_fold_reference(data, rb, st):
    """(k, n) weights — the fold axis written out — against k calls of
    the reference."""
    W, Wt = data["W"], torch.from_numpy(data["W"])
    X, y, v = (torch.from_numpy(data[k]) for k in ("X", "y", "v"))
    kw = dict(row_block=rb, strategy=st)
    G, n_eff = tm.weighted_gram(X, Wt, intercept=True, append=y, **kw)
    H, u, n2 = tm.weighted_gram_and_vec(X, Wt, Wt * v, intercept=True, **kw)
    with jsg_ops.force_backend("interpret"):
        for j in range(_K):
            jG, jn = jm.weighted_gram(jnp.asarray(data["X"]),
                                      jnp.asarray(W[j]), intercept=True,
                                      append=jnp.asarray(data["y"]), **kw)
            jH, ju, _ = jm.weighted_gram_and_vec(
                jnp.asarray(data["X"]), jnp.asarray(W[j]),
                jnp.asarray(W[j] * data["v"]), intercept=True, **kw)
            _close(G[j].numpy(), np.asarray(jG), f"G[{j}]")
            _close(n_eff[j].numpy(), np.asarray(jn), f"n_eff[{j}]")
            _close(H[j].numpy(), np.asarray(jH), f"H[{j}]")
            _close(u[j].numpy(), np.asarray(ju), f"u[{j}]")
    assert n2.shape == (_K,)


@pytest.mark.parametrize("n,rb", [(_N, _RB), (1024, 256), (777, 100)])
def test_chunked_equals_whole_bitwise(data, n, rb):
    td = {k: torch.from_numpy(v[:n] if v.shape[0] == _N else v)
          for k, v in data.items()}
    td["folds"] = td["folds"].long()
    td["W"] = torch.from_numpy(data["W"][:, :n])
    c = _forms(tm, td, rb, "chunked")
    w = _forms(tm, td, rb, "whole")
    for name in c:
        for g, h in zip(_leaves(c[name]), _leaves(w[name])):
            assert torch.equal(g, h), name
    gc = tm.weighted_gram(td["X"], td["W"], intercept=True, row_block=rb,
                          strategy="chunked")
    gw = tm.weighted_gram(td["X"], td["W"], intercept=True, row_block=rb,
                          strategy="whole")
    assert torch.equal(gc[0], gw[0]) and torch.equal(gc[1], gw[1])


def test_fold_counts_exact(data):
    X = torch.from_numpy(data["X"])
    folds = torch.from_numpy(data["folds"]).long()
    for rb, st in [(0, None), (_RB, "chunked"), (_RB, "pallas")]:
        _, c = tm.fold_gram(X, folds, _K, row_block=rb, strategy=st)
        np.testing.assert_array_equal(
            c.numpy(), np.bincount(data["folds"], minlength=_K))


def test_fallback_counter(data):
    """A form with no fused builder under strategy="pallas" runs chunked
    (same bits) and is counted; the slice's forms are never counted."""
    tm.FALLBACKS.clear()
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    td["folds"] = td["folds"].long()
    _forms(tm, td, _RB, "pallas")
    assert not any(tm.FALLBACKS.values()), tm.FALLBACKS

    def block(Xb, wb):
        return (Xb * wb[:, None]).T @ Xb

    ref = tm.blocked_reduce(block, (td["X"], td["w"]), row_block=_RB,
                            strategy="chunked")
    got = tm.blocked_reduce(block, (td["X"], td["w"]), row_block=_RB,
                            strategy="pallas", form="custom_form")
    assert torch.equal(ref, got)
    assert tm.FALLBACKS.get("custom_form") == 1
    tm.FALLBACKS.clear()


def test_unknown_strategy_raises(data):
    X = torch.from_numpy(data["X"])
    with pytest.raises(ValueError, match="unknown strategy"):
        tm.weighted_gram(X, torch.ones(_N), row_block=_RB, strategy="bogus")
