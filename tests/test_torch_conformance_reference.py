"""The cross-estimator conformance suite on the port, part 3: every
SPEC against the JAX package on the reference's conformance data and
folds (part 1's module docstring).

  * each spec's point estimate (and theta, where the result has one),
    torch against the reference's fit, within rtol 1e-4 plus atol 1e-5
    (fp32 moments summed in another order, 16 Newton steps; ROADMAP §C);
    each reference fit is made once per module;
  * truth recovery: every port estimate within its spec's ``truth_tol``
    of the data's true ATE / LATE;
  * ``iv_gram``'s slice map against direct fp64 sums, within rtol 1e-5
    plus an atol of 1e-5·max|x| (fp32 cross-moments carry ~1e-5 relative
    error; the reference's own test of this misses by 1.12e-5 without
    one, ROADMAP §C), and chunked ≡ whole bitwise.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import registry as jregistry  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
# the submodule, not the ``crossfit`` function ``repro_torch.core`` re-exports
tcf = importlib.import_module("repro_torch.core.crossfit")
from repro_torch.core import drlearner as tdr  # noqa: E402
from repro_torch.core import iv as tiv  # noqa: E402
from repro_torch.core import moments  # noqa: E402
from repro_torch.core.registry import ROW_BLOCK, SPEC_IDS, SPECS  # noqa: E402
from repro_torch.data.causal_dgp import CausalData, IVData  # noqa: E402

_FIT_KEY = jax.random.PRNGKey(0)
_DATA_KEY = jax.random.PRNGKey(42)
# how many ways each reference fit splits its key; the first part draws
# its folds
_SPLITS = {"dml": 3, "dml_p2_rb": 3, "dml_loo": 3, "drlearner": 4,
           "orthoiv": 4, "orthoiv_p2_rb": 4, "driv": 4}
_DATA = {}


def _data(spec):
    """(the reference's conformance data, the same data in the port),
    made once per data maker."""
    ref = jregistry.get_spec(spec.name)
    if ref.make_data not in _DATA:
        jd = ref.make_data(_DATA_KEY)
        cls = IVData if spec.needs_instrument else CausalData
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(jd, f.name)
            kw[f.name] = (float(v) if np.ndim(v) == 0 else
                          torch.from_numpy(np.array(v, np.float32)))
        _DATA[ref.make_data] = (jd, cls(**kw))
    return _DATA[ref.make_data]


def _fit(spec, cfg, monkeypatch):
    """The port's fit of ``spec`` on the reference's data and folds."""
    jd, data = _data(spec)
    if spec.name in _SPLITS:
        kf = jax.random.split(_FIT_KEY, _SPLITS[spec.name])[0]
        folds = torch.from_numpy(np.asarray(
            jfold_ids(kf, data.n, cfg.n_folds)).astype(np.int64))
        for mod in (tcf, tdr, tiv):
            monkeypatch.setattr(mod, "fold_ids",
                                lambda gen, n, k, device=None: folds)
    return spec.fit(data, cfg, None)


@functools.lru_cache(maxsize=None)
def _reference_fit(name):
    ref = jregistry.get_spec(name)
    return ref.fit(_data(ref)[0], ref.base_cfg, _FIT_KEY)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_point_matches_reference(spec, monkeypatch):
    jres = _reference_fit(spec.name)
    res = _fit(spec, spec.base_cfg, monkeypatch)
    want = jregistry.get_spec(spec.name).point(jres)
    np.testing.assert_allclose(spec.point(res), want, rtol=1e-4, atol=1e-5,
                               err_msg=spec.name)
    if hasattr(jres, "theta"):
        np.testing.assert_allclose(res.theta.numpy(), np.asarray(jres.theta),
                                   rtol=1e-4, atol=1e-5, err_msg=spec.name)
    if hasattr(jres, "cate") and not callable(jres.cate):
        np.testing.assert_allclose(res.cate.numpy(), np.asarray(jres.cate),
                                   rtol=1e-4, atol=1e-5, err_msg=spec.name)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_truth_recovery(spec, monkeypatch):
    data = _data(spec)[1]
    res = _fit(spec, spec.base_cfg, monkeypatch)
    err = abs(spec.point(res) - spec.truth(data))
    assert err < spec.truth_tol, (spec.name, spec.point(res),
                                  spec.truth(data))


def test_iv_gram_slices_consistent():
    g = torch.Generator().manual_seed(5)
    n, p = 777, 2
    ry, rt, rz = (torch.randn(n, generator=g) for _ in range(3))
    phi = torch.randn((n, p), generator=g)
    w = torch.empty(n).exponential_(1.0, generator=g)
    Gaug, n_eff = moments.iv_gram(ry, rt, rz, phi, w)
    J, b, Szz, Stt = moments.iv_slices(Gaug, p)
    d = {k: v.double().numpy() for k, v in
         dict(ry=ry, rt=rt, rz=rz, phi=phi, w=w).items()}

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    close(J, np.einsum("n,ni,nj->ij", d["w"] * d["rz"] * d["rt"], d["phi"],
                       d["phi"]))
    close(b, np.einsum("n,ni->i", d["w"] * d["rz"] * d["ry"], d["phi"]))
    close(Szz, np.einsum("n,ni,nj->ij", d["w"] * d["rz"] * d["rz"],
                         d["phi"], d["phi"]))
    close(Stt, np.einsum("n,ni,nj->ij", d["w"] * d["rt"] * d["rt"],
                         d["phi"], d["phi"]))
    assert float(n_eff) == pytest.approx(float(w.sum()))
    a = moments.iv_gram(ry, rt, rz, phi, w, row_block=ROW_BLOCK,
                        strategy="chunked")
    bb = moments.iv_gram(ry, rt, rz, phi, w, row_block=ROW_BLOCK,
                         strategy="whole")
    assert torch.equal(a[0], bb[0])
