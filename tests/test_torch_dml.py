"""The slice as a whole: the port's DML fit + delete-fold jackknife held
against ``repro.core.dml.DML(cfg).fit``, plus the port's own contracts.

  * on the reference's folds, the port's ``crossfit_one`` ×2 +
    ``fit_final_stage`` + ``delete_fold_jackknife`` — exactly what
    ``DML.fit`` composes — against the JAX fit at the quickstart
    configuration, row_block 512 (strategy pallas; the reference runs
    its CPU default lowering) and row_block 0: theta, cov, diagnostics
    and the jackknife interval; and the port's own ``DML.fit`` on those
    folds gives the composition bitwise;
  * the port's ``DML.fit`` on the CPU recovers theta = [1, 0.5] of
    ``paper_demo_data`` within 5 se;
  * ``CausalConfig`` agrees field for field with the reference's;
  * ``device=None`` without CUDA raises;
  * import hygiene: no module of the port, nor ``chip_smoke.py``, loads
    ``jax`` or ``repro``.

Tolerances: theta, cov and jackknife se rtol 1e-4 (16 fp32 Newton steps
and two frameworks' reassociation, ~1e-6 measured), with an atol of
1e-4·max|x| for entries near 0; diagnostics rtol 1e-4, atol 1e-5 (means
of O(1) residuals that are ~1e-3).
"""
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.dml import DML as JDML  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
# the submodule, not the ``crossfit`` function ``repro_torch.core`` re-exports
tcf = importlib.import_module("repro_torch.core.crossfit")
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.estimands import compute_diagnostics  # noqa: E402
from repro_torch.core.final_stage import cate_basis, fit_final_stage  # noqa: E402
from repro_torch.core.nuisance import make_nuisance  # noqa: E402
from repro_torch.inference.jackknife import delete_fold_jackknife  # noqa: E402

_N, _P = 2000, 8
REPO = Path(__file__).resolve().parents[1]


def _close(got, want, msg="", rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((_N, _P)).astype(np.float32)
    prop = 1.0 / (1.0 + np.exp(-X[:, 0]))
    t = (rng.random(_N) < prop).astype(np.float32)
    y = ((1 + 0.5 * X[:, 0]) * t + X[:, 0]
         + rng.standard_normal(_N)).astype(np.float32)
    return X, y, t


def _port_composition(cfg, X, y, t, folds):
    """What DML.fit composes, on given folds."""
    gen = torch.Generator().manual_seed(0)
    ny = make_nuisance(cfg.nuisance_y, "reg", cfg)
    nt = make_nuisance(cfg.nuisance_t, "clf", cfg)
    oof_y, _ = tcf.crossfit_one(ny, gen, X, y, folds, cfg.n_folds, cfg.engine)
    oof_t, _ = tcf.crossfit_one(nt, gen, X, t, folds, cfg.n_folds, cfg.engine)
    phi = cate_basis(X, cfg.cate_features)
    fs = fit_final_stage(y, t, oof_y, oof_t, phi, row_block=cfg.row_block,
                         strategy=cfg.row_block_strategy)
    diag = compute_diagnostics(y, t, oof_y, oof_t, phi @ fs.theta)
    jk = delete_fold_jackknife(y, t, oof_y, oof_t, folds, phi, cfg.n_folds,
                               alpha=cfg.alpha, point=fs.theta,
                               point_se=fs.stderr, row_block=cfg.row_block)
    return fs, diag, jk


@pytest.mark.parametrize("rb", [512, 0])
def test_slice_matches_reference(data, rb, monkeypatch):
    kw = dict(n_folds=5, cate_features=2, row_block=rb,
              row_block_strategy="pallas", inference="jackknife")
    jres = JDML(JCausalConfig(**kw)).fit(*map(jax.numpy.asarray, data[1:]),
                                         jax.numpy.asarray(data[0]),
                                         key=jax.random.PRNGKey(0))
    jlo, jhi = jres.ate_interval()
    jinf = jres.inference()

    X, y, t = convert.data(*data, device="cpu")
    folds = convert.folds(jres.crossfit.folds, device="cpu")
    cfg = CausalConfig(**kw)
    fs, diag, jk = _port_composition(cfg, X, y, t, folds)

    _close(fs.theta.numpy(), np.asarray(jres.theta), "theta")
    _close(fs.cov.numpy(), np.asarray(jres.cov), "cov")
    _close(jk.se.numpy(), np.asarray(jinf.se), "jackknife se")
    _close(jk.replicates.numpy(), np.asarray(jinf.replicates), "replicates")
    lo, hi = jk.ate_interval()
    _close([lo, hi], [jlo, jhi], "jackknife ATE interval")
    for name, want in jres.diagnostics.rows().items():
        np.testing.assert_allclose(getattr(diag, name), want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)

    # the port's own DML.fit on the same folds is that composition
    monkeypatch.setattr(tcf, "fold_ids", lambda gen, n, k, device=None:
                        folds.to(device))
    res = DML(cfg, device="cpu").fit(y, t, X)
    assert torch.equal(res.theta, fs.theta)
    assert torch.equal(res.inference().se, jk.se)
    assert res.ate_interval() == (lo, hi)
    band = res.cate_interval(X[:7])
    jband = jres.cate_interval(jax.numpy.asarray(data[0][:7]))
    for got, want in zip(band, jband):
        _close(got.numpy(), np.asarray(want), "jackknife CATE band")


@pytest.mark.parametrize("engine", ["parallel", "parallel_loo"])
def test_dml_recovers_truth(engine):
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=4000, p=10, seed=3, device="cpu")
    cfg = CausalConfig(n_folds=5, cate_features=2, engine=engine,
                       inference="jackknife", row_block=512,
                       row_block_strategy="pallas")
    res = DML(cfg, device="cpu").fit(d.y, d.t, d.X)
    se = torch.maximum(res.inference().se, res.stderr)
    z = (res.theta - torch.tensor([1.0, 0.5])).abs() / se
    assert bool((z <= 5.0).all()), (res.theta, se)
    assert "DML result" in res.summary()


def test_make_causal_data_effect_recovered():
    from repro_torch.data.causal_dgp import make_causal_data

    d = make_causal_data(4000, 6, seed=4, device="cpu", effect=2.0)
    assert d.X.shape == (4000, 6) and d.true_ate == 2.0
    assert set(d.t.unique().tolist()) <= {0.0, 1.0}
    res = DML(CausalConfig(inference="jackknife"), device="cpu").fit(
        d.y, d.t, d.X)
    assert abs(res.ate - 2.0) <= 5 * float(res.stderr[0])


@pytest.mark.parametrize("over", [{}, dict(n_folds=3, row_block=256,
                                           row_block_strategy="pallas",
                                           mlp_hidden=(8,), alpha=0.1,
                                           engine="parallel_loo")])
def test_config_matches_reference(over):
    assert dataclasses.asdict(CausalConfig(**over)) == \
        dataclasses.asdict(JCausalConfig(**over))
    assert [f.name for f in dataclasses.fields(CausalConfig)] == \
        [f.name for f in dataclasses.fields(JCausalConfig)]


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DML(CausalConfig())
    from repro_torch.data.causal_dgp import paper_demo_data
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_demo_data(n=10, p=2)


def test_bootstrap_inference_waits_for_its_slice(data):
    """The default inference (the pairs bootstrap) is served, under a
    memory budget too; what is still to come raises naming its ROADMAP
    item; the shard_map executor, outside a data mesh, raises."""
    X, y, t = convert.data(*data, device="cpu")
    res = DML(CausalConfig(n_bootstrap=4), device="cpu").fit(
        y[:500], t[:500], X[:500])
    lo, hi = res.ate_interval()
    assert lo < hi and res.inference().method == "pairs"
    with pytest.raises(ValueError, match="DataMesh"):
        res.inference(executor="shard_map")
    # inside a data mesh it splits the replicates over the mesh's ranks
    # (one here): the same replicates as vmap
    from repro_torch.runtime import make_data_mesh, use_data_mesh
    with use_data_mesh(make_data_mesh(device="cpu")):
        sharded = res.inference(executor="shard_map")
    assert torch.equal(sharded.replicates, res.inference().replicates)
    # the memory budget reaches the task runtime (one chunk on the CPU,
    # where torch keeps no peak counter): the same interval
    budgeted = DML(CausalConfig(n_bootstrap=4, runtime_memory_budget=1 << 30),
                   device="cpu").fit(y[:500], t[:500], X[:500])
    assert budgeted.ate_interval() == (lo, hi)


def test_numerics_and_intervals():
    from repro.inference.intervals import z_crit as jz
    from repro_torch.inference.intervals import z_crit
    from repro_torch.inference.numerics import det_inv, det_solve

    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, 3, 3))
    A = torch.from_numpy(M @ M.transpose(0, 2, 1) + 3 * np.eye(3))
    b = torch.from_numpy(rng.standard_normal((4, 3)))
    np.testing.assert_allclose(det_solve(A, b).numpy(),
                               torch.linalg.solve(A, b).numpy(), rtol=1e-10)
    np.testing.assert_allclose(det_inv(A).numpy(),
                               torch.linalg.inv(A).numpy(), rtol=1e-10)
    assert torch.equal(det_solve(A, b)[2], det_solve(A[2], b[2]))
    for a in (0.05, 0.1, 0.01):
        assert abs(z_crit(a) - jz(a)) < 1e-6


def test_convert_round_trip():
    rng = np.random.default_rng(1)
    st = {"beta": rng.standard_normal((5, 4)), "lam": np.full(5, 1e-3)}
    out = convert.fold_states(st, device="cpu")
    assert out["beta"].dtype == torch.float32 and out["beta"].shape == (5, 4)
    th, cov = convert.theta_cov(np.ones(2), np.eye(2), device="cpu")
    assert th.shape == (2,) and cov.shape == (2, 2)
    assert convert.folds(np.arange(3, dtype=np.int32),
                         device="cpu").dtype == torch.int64


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without
    loading jax or any module of the JAX package (the elastic re-mesh,
    the paper cell's lowerings and the estimator protocol named)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from repro_torch.core.estimator import CausalEstimator, fit_adapter\n"
        "from repro_torch.launch.dml_cell import lower_dml_cell, lower_iv_cell\n"
        "from repro_torch.launch.sweep_cell import lower_sweep_cell\n"
        "from repro_torch.launch.elastic import elastic_restore, state_shardings\n"
        "from repro_torch.distributed.sharding import pad, row_sum, rows_like\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": f"{REPO / 'src'}:{REPO}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
