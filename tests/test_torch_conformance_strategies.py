"""The cross-estimator conformance suite on the port, part 1: the
execution-strategy contracts over every SPEC of the registry (all ten,
``repro_torch.core.registry`` mirroring ``repro.core.registry``), on the
reference's conformance data (``make_data(PRNGKey(42))``: 1100 rows, a
ragged last block at ROW_BLOCK = 256) and the reference's folds.

  * chunked ≡ whole, bitwise, all the way out to every floating tensor
    of the result (``registry.tree_arrays``);
  * the "pallas" strategy (the kernel's plain version on the CPU)
    against "chunked": the point estimate and theta within 1e-6, the
    reference's own tolerance between these strategies;
  * row_block 0 against 256: within each spec's ``rb_tol`` (theta within
    rtol 2e-3 + atol 2e-4), float reassociation only.

Parts 2 and 3: tests/test_torch_conformance_{inference,reference}.py.
"""
import dataclasses
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
from repro_torch.core.registry import (ROW_BLOCK, SPEC_IDS, SPECS,  # noqa: E402
                                       tree_arrays)
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


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_chunked_equals_whole_bitwise(spec, monkeypatch):
    cfg_c = dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK,
                                row_block_strategy="chunked")
    cfg_w = dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK,
                                row_block_strategy="whole")
    la = tree_arrays(_fit(spec, cfg_c, monkeypatch))
    lb = tree_arrays(_fit(spec, cfg_w, monkeypatch))
    assert len(la) == len(lb) > 0, spec.name
    for a, b in zip(la, lb):
        assert torch.equal(a, b), spec.name


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_pallas_strategy_parity(spec, monkeypatch):
    cfg_c = dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK,
                                row_block_strategy="chunked")
    cfg_p = dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK,
                                row_block_strategy="pallas")
    r_c = _fit(spec, cfg_c, monkeypatch)
    r_p = _fit(spec, cfg_p, monkeypatch)
    np.testing.assert_allclose(spec.point(r_c), spec.point(r_p), rtol=1e-6,
                               atol=1e-6, err_msg=spec.name)
    if hasattr(r_c, "theta"):
        np.testing.assert_allclose(r_c.theta.numpy(), r_p.theta.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=spec.name)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_row_block_invariance(spec, monkeypatch):
    r0 = _fit(spec, spec.base_cfg, monkeypatch)
    rb = _fit(spec, dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK),
              monkeypatch)
    assert abs(spec.point(r0) - spec.point(rb)) < spec.rb_tol, spec.name
    if hasattr(r0, "theta"):
        np.testing.assert_allclose(r0.theta.numpy(), rb.theta.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=spec.name)


def test_registry_mirrors_reference_conformance_fields():
    """Every spec's conformance fields are the reference's: names,
    tolerances, which specs bootstrap, the bootstrap configs; and the
    port's own ``make_data`` draws data of the reference's shape."""
    assert SPEC_IDS == jregistry.SPEC_IDS
    for spec in SPECS:
        ref = jregistry.get_spec(spec.name)
        assert (spec.truth_tol, spec.rb_tol) == (ref.truth_tol, ref.rb_tol)
        assert (spec.boot is None) == (ref.boot is None), spec.name
        if ref.boot_cfg is not None:
            assert dataclasses.asdict(spec.boot_cfg) == \
                dataclasses.asdict(ref.boot_cfg), spec.name
        d = spec.make_data(0, device="cpu")
        assert tuple(d.X.shape) == tuple(_data(spec)[1].X.shape)
        assert spec.truth(d) == pytest.approx(spec.truth(_data(spec)[1]))
