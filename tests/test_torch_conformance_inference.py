"""The cross-estimator conformance suite on the port, part 2: the
inference and configuration contracts over every SPEC, on the
reference's conformance data and folds (part 1's module docstring).

  * serial ≡ batched bootstrap replicates, bitwise, for every spec with
    a bootstrap, at its row-blocked ``boot_cfg`` (B = 4) — proved in
    torch: the reference's own serial ≡ vmap tests are red on this host
    (ROADMAP §C) and are not used as an oracle;
  * the metalearners' ``ate_interval`` (B = 8): finite, ordered, within
    0.3 of the truth, and their CATE bands refuse;
  * config round trip: ``CausalConfig(**asdict(cfg)) == cfg`` with the
    sweep fields set, and the round-tripped config drives a bitwise fit;
  * the meat forms' batch invariance on the row-blocked path ("chunked"
    and "pallas"): serial ≡ batched executors bitwise, chunked ≡ whole.
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
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core import moments  # noqa: E402
from repro_torch.core.registry import (ROW_BLOCK, SPEC_IDS, SPECS,  # noqa: E402
                                       tree_arrays)
from repro_torch.inference.executor import make_executor  # noqa: E402
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


_BOOT = [s for s in SPECS if s.boot is not None]
_META = [s for s in SPECS if s.name in ("s_learner", "t_learner",
                                        "x_learner")]


@pytest.mark.parametrize("spec", _BOOT, ids=[s.name for s in _BOOT])
def test_serial_equals_batched_bitwise(spec, monkeypatch):
    _fit(spec, spec.boot_cfg, monkeypatch)          # hands in the folds
    data = _data(spec)[1]
    r_ser = spec.boot(data, spec.boot_cfg, None, "serial", 4)
    r_vec = spec.boot(data, spec.boot_cfg, None, "vmap", 4)
    assert torch.equal(r_ser.replicates, r_vec.replicates), spec.name
    for attr in ("replicate_se", "ate_replicates"):
        a, b = getattr(r_ser, attr), getattr(r_vec, attr)
        assert (a is None) == (b is None), (spec.name, attr)
        if a is not None:
            assert torch.equal(a, b), (spec.name, attr)


@pytest.mark.parametrize("spec", _META, ids=[s.name for s in _META])
def test_metalearner_ate_interval(spec, monkeypatch):
    cfg = dataclasses.replace(spec.base_cfg, inference="bootstrap",
                              n_bootstrap=8)
    res = _fit(spec, cfg, monkeypatch)
    lo, hi = res.ate_interval()
    assert np.isfinite(lo) and np.isfinite(hi) and lo < hi
    truth = spec.truth(_data(spec)[1])
    assert lo - 0.3 < truth < hi + 0.3, spec.name
    with pytest.raises(ValueError):
        res.cate_interval(_data(spec)[1].X)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_config_round_trip(spec, monkeypatch):
    cfg = dataclasses.replace(spec.base_cfg, segment_key="cohort",
                              sweep_chunk=8)
    cfg2 = CausalConfig(**dataclasses.asdict(cfg))
    assert cfg2 == cfg
    assert (cfg2.segment_key, cfg2.sweep_chunk) == ("cohort", 8)
    la = tree_arrays(_fit(spec, cfg, monkeypatch))
    lb = tree_arrays(_fit(spec, cfg2, monkeypatch))
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        assert torch.equal(a, b), spec.name


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("kernel", ["residual", "iv"])
def test_meat_forms_batch_invariant(kernel, p, strategy):
    g = torch.Generator().manual_seed(3)
    n, R = 1100, 4
    ry, rt, rz = (torch.randn(n, generator=g) for _ in range(3))
    phi = torch.randn((n, p), generator=g)
    W = torch.empty((R, n)).exponential_(1.0, generator=g)
    theta = torch.arange(1.0, p + 1)

    def fn(w):
        c = w.shape[0]
        rows = [x.expand(c, n) for x in (ry, rt, rz)]
        th = theta.expand(c, p)
        if kernel == "residual":
            zero = torch.zeros(c, n)
            return moments.residual_meat(rows[0], rows[1], zero, zero, phi,
                                         th, w=w, row_block=ROW_BLOCK,
                                         strategy=strategy)
        return moments.iv_meat(*rows, phi, th, w=w, row_block=ROW_BLOCK,
                               strategy=strategy)

    ser = make_executor("serial").map(fn, W)
    vec = make_executor("vmap").map(fn, W)
    assert torch.equal(ser, vec)
    if strategy == "chunked":
        whole = {"residual": lambda: moments.residual_meat(
            ry, rt, torch.zeros(n), torch.zeros(n), phi, theta, w=W[0],
            row_block=ROW_BLOCK, strategy="whole"),
            "iv": lambda: moments.iv_meat(ry, rt, rz, phi, theta, w=W[0],
                                          row_block=ROW_BLOCK,
                                          strategy="whole")}[kernel]()
        assert torch.equal(whole, vec[0])
