"""The port's last three examples on the CPU, and the slice against the
reference through the package surfaces.

  * ``examples/torch_{iv,store,sweep}_demo.py``'s ``main`` at small
    sizes with ``--device cpu``: the OrthoIV LATE within 5 se of the
    truth with both intervals finite and around it, the store bitwise a
    from-scratch refit every day, the cells panel bitwise the serial
    loop, every valid segment's ATE finite;
  * the seg_gram launches each demo would make on the card, counted by
    form from the CPU run (every Gram goes through ``seg_gram.ops.
    seg_reduce`` or ``residual_gram.ops.residual_gram``, each call
    counted under the key its CUDA wrapper counts it by): the demos take
    the kernel's route;
  * ``repro.core.DML`` / ``OrthoIV`` and ``repro_torch.core.DML`` /
    ``OrthoIV`` on the same data (the reference's ``make_iv_data``,
    JAX -> numpy -> torch) and the reference's folds: θ / LATE and the
    standard error within rtol 1e-4 + atol 1e-5 (three 16-step Newton
    nuisances and two frameworks' reassociation; the atol because fp32
    cross-moments part by ~1e-5 relative, ROADMAP §C).
"""
import collections
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels.residual_gram import kernel as rg_kernel  # noqa: E402
from repro_torch.kernels.residual_gram import ops as rg_ops  # noqa: E402
from repro_torch.kernels.seg_gram import ops as sg_ops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def _demo(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def launches(monkeypatch):
    """Counts, by LAUNCHES key, of the kernel launches the card would
    make: ``seg_gram.ops.launch_key`` of each ``seg_reduce`` call, and
    ``residual_gram.kernel.LAUNCH_KEY`` of each ``residual_gram``."""
    counts = collections.Counter()
    seg_reduce, residual_gram = sg_ops.seg_reduce, rg_ops.residual_gram

    def counted_seg_reduce(builder, arrays, *, seg=None, w=None,
                           n_segments=1, init=None, row_block=0):
        counts[sg_ops.launch_key(builder, [a.float() for a in arrays], w=w,
                                 n_segments=n_segments, init=init)] += 1
        return seg_reduce(builder, arrays, seg=seg, w=w,
                          n_segments=n_segments, init=init,
                          row_block=row_block)

    def counted_residual_gram(*args):
        counts[rg_kernel.LAUNCH_KEY] += 1
        return residual_gram(*args)

    monkeypatch.setattr(sg_ops, "seg_reduce", counted_seg_reduce)
    monkeypatch.setattr(rg_ops, "residual_gram", counted_residual_gram)
    return counts


def test_iv_demo(launches):
    out = _demo("torch_iv_demo").main(["--device", "cpu", "--n", "2000",
                                       "--b", "8"])
    late, se = out["late"], out["se"]
    assert abs(late - out["true_late"]) <= 5 * se, (late, se)
    for lo, hi in (out["bootstrap_ci"], out["jackknife_ci"]):
        assert np.isfinite([lo, hi]).all() and lo <= late <= hi
    assert out["weak"].passed
    assert abs(out["driv_late"] - out["true_late"]) <= 5 * out["driv_se"]
    assert dict(launches) == {
        "design": 5, "gram_and_vec": 80, "fold_weighted": 65, "iv": 3,
        "iv_meat": 3, "iv_segmented": 1, "residual": 1, "residual_meat": 1}


def test_store_demo(launches):
    demo = _demo("torch_store_demo")
    argv = ["--device", "cpu", "--days", "3", "--n", "2048"]
    out = demo.main(argv)                   # the CPU's "chunked" days
    assert out["bitwise"] == [True, True, True]
    assert out["version"] == 3 and out["latest"] == 3
    assert not launches
    # the card's route: each day the ingest's and the refit's ng and vg
    # pair walks; on the CPU their plain version adds a day's moments to
    # the store's, so the days agree with the chunked run to rounding
    kern = demo.main(argv + ["--strategy", "pallas"])
    assert dict(launches) == {"pair": 12}
    assert kern["version"] == 3 and kern["bitwise"][0]
    np.testing.assert_allclose(kern["ates"].numpy(), out["ates"].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_sweep_demo(launches):
    out = _demo("torch_sweep_demo").main(["--device", "cpu", "--n", "2048",
                                          "--e", "4", "--b", "4"])
    panel = out["panel"]
    assert out["bitwise"]
    assert torch.equal(panel.columns[0].thetas, out["loop"]["theta"])
    for p in (panel, out["segmented"]):
        ok = p.ok()                                   # (E, C)
        assert bool(ok.all())
        for c, col in enumerate(p.columns):
            assert bool(torch.isfinite(col.ates[ok[:, c]]).all())
    assert dict(launches) == {
        "fold_weighted": 198, "residual_direct": 7, "residual_meat": 7,
        "design_segmented": 2, "pair": 66}


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_slice_against_the_reference_through_the_surfaces(monkeypatch):
    import repro.core as jcore
    from repro.config import CausalConfig as JCausalConfig
    from repro.data.causal_dgp import make_iv_data as jmake_iv_data

    import repro_torch.core as tcore
    from repro_torch.config import CausalConfig

    d = jmake_iv_data(jax.random.PRNGKey(42), 2000, 10, effect=1.5,
                      compliance=0.7)
    y, t, z, X = (torch.from_numpy(np.array(a)) for a in (d.y, d.t, d.z,
                                                           d.X))
    kw = dict(n_folds=5, nuisance_z="logistic", inference="none",
              row_block=1024, row_block_strategy="pallas")
    key = jax.random.PRNGKey(0)
    jdml = jcore.DML(JCausalConfig(**kw)).fit(d.y, d.t, d.X, key=key)
    jiv = jcore.OrthoIV(JCausalConfig(**kw)).fit(d.y, d.t, d.z, d.X, key=key)

    tcf = importlib.import_module("repro_torch.core.crossfit")
    folds = convert.folds(jdml.crossfit.folds, device="cpu")
    monkeypatch.setattr(tcf, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    dml = tcore.DML(CausalConfig(**kw), device="cpu").fit(y, t, X)
    _close(dml.ate, jdml.ate, "DML ATE")
    _close(dml.stderr.numpy(), np.asarray(jdml.stderr), "DML se")

    folds = convert.folds(jiv.crossfit.folds, device="cpu")
    monkeypatch.setattr(importlib.import_module("repro_torch.core.iv"),
                        "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    iv = tcore.OrthoIV(CausalConfig(**kw), device="cpu").fit(y, t, z, X)
    _close(iv.late, jiv.late, "OrthoIV LATE")
    _close(iv.stderr.numpy(), np.asarray(jiv.stderr), "OrthoIV se")
