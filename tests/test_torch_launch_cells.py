"""The paper's workloads as single steps (``repro_torch.launch.dml_cell``,
``launch.sweep_cell``) held against the reference's steps
(``repro.launch.dml_cell``, ``repro.launch.sweep_cell``) under
``jax.jit``, at the IV cell's smoke shape (n = 512, p = 8;
tests/test_iv.py) and on the reference's folds.

  * ``make_dml_step`` / ``make_iv_step`` on both engines: theta and cov
    within rtol 1e-4 plus an atol of 1e-4·max (tests/test_torch_dml.py's
    tolerance); the folds are data to both packages;
  * ``make_sweep_step``: "cells" on the reference's per-cell folds (the
    port's ``engine.cell_folds`` replaced), "segmented" on its shared
    folds (``segmented.fold_ids`` replaced), within rtol 2e-4 plus atol
    2e-4 (tests/test_torch_sweep.py's);
  * inside torch, bitwise: the steps ≡ ``DML`` / ``OrthoIV``'s fit on the
    folds they draw, and "cells" ≡ ``serial_loop(seed=0, col_index=0)``;
  * ``input_specs`` has the reference's shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.crossfit import fold_ids as jfold_ids  # noqa: E402
from repro.data.causal_dgp import make_iv_data as jmake_iv_data  # noqa: E402
from repro.launch import dml_cell as jdml_cell  # noqa: E402
from repro.launch import sweep_cell as jsweep_cell  # noqa: E402
from repro.sweep import column_keys as jcolumn_keys  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.launch import dml_cell, sweep_cell  # noqa: E402
from repro_torch.sweep import column_keys, engine, segmented  # noqa: E402
from repro_torch.sweep import serial_loop  # noqa: E402

N, P, K, E = 512, 8, 5, 4
_STEP_TOL = 1e-4
_SWEEP_TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(**kw) -> dict:
    base = dict(n_folds=K, nuisance_y="ridge", nuisance_t="logistic",
                nuisance_z="logistic", cate_features=1, newton_iters=6,
                inference="none", row_block_strategy="chunked")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def data():
    d = jmake_iv_data(jax.random.PRNGKey(3), N, P)
    out = {k: np.array(getattr(d, k), np.float32) for k in ("X", "y", "t",
                                                            "z")}
    out["folds"] = np.asarray(jfold_ids(jax.random.PRNGKey(0), N, K)
                              ).astype(np.int64)
    out["sids"] = np.random.default_rng(4).integers(0, E, N).astype(np.int64)
    return out


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=_STEP_TOL,
                               atol=_STEP_TOL * float(np.abs(want).max()))


def _jargs(data, names):
    return [jnp.asarray(data[n]) if n != "folds"
            else jnp.asarray(data[n], jnp.int32) for n in names]


@pytest.mark.parametrize("engine_name,rb", [("parallel", 0),
                                            ("parallel_loo", 128)])
def test_dml_step_matches_reference(data, engine_name, rb):
    kw = _cfg(row_block=rb, cate_features=2)
    jstep = jax.jit(jdml_cell.make_dml_step(JCausalConfig(**kw), engine_name))
    jt, jc = jstep(*_jargs(data, ("X", "y", "t", "folds")))
    step = dml_cell.make_dml_step(CausalConfig(**kw), engine_name,
                                  device="cpu")
    theta, cov = step(*(data[n] for n in ("X", "y", "t", "folds")))
    _close(theta, jt)
    _close(cov, jc)


@pytest.mark.parametrize("engine_name,rb", [("parallel", 128),
                                            ("parallel_loo", 0)])
def test_iv_step_matches_reference(data, engine_name, rb):
    kw = _cfg(row_block=rb)
    jstep = jax.jit(jdml_cell.make_iv_step(JCausalConfig(**kw), engine_name))
    jt, jc = jstep(*_jargs(data, ("X", "y", "t", "z", "folds")))
    step = dml_cell.make_iv_step(CausalConfig(**kw), engine_name,
                                 device="cpu")
    theta, cov = step(*(data[n] for n in ("X", "y", "t", "z", "folds")))
    _close(theta, jt)
    _close(cov, jc)


@pytest.mark.parametrize("engine_name", ["parallel", "parallel_loo"])
def test_steps_bitwise_the_estimators(data, engine_name):
    """Given the folds ``DML`` / ``OrthoIV`` draw from seed 0, each step
    is their fit bit for bit (the same engines, on "pallas" blocks)."""
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.core.dml import DML
    from repro_torch.core.iv import OrthoIV

    cfg = CausalConfig(**_cfg(row_block=128, row_block_strategy="pallas",
                              engine=engine_name, cate_features=2))
    folds = fold_ids(torch.Generator().manual_seed(0), N, K)
    X, y, t, z = (torch.from_numpy(data[n]) for n in ("X", "y", "t", "z"))
    theta, cov = dml_cell.make_dml_step(cfg, engine_name, device="cpu")(
        X, y, t, folds)
    res = DML(cfg, device="cpu").fit(y, t, X,
                                     gen=torch.Generator().manual_seed(0))
    assert torch.equal(theta, res.theta) and torch.equal(cov, res.cov)
    icfg = dataclasses.replace(cfg, cate_features=1)
    theta, cov = dml_cell.make_iv_step(icfg, engine_name, device="cpu")(
        X, y, t, z, folds)
    res = OrthoIV(icfg, device="cpu").fit(
        y, t, z, X, gen=torch.Generator().manual_seed(0))
    assert torch.equal(theta, res.theta) and torch.equal(cov, res.cov)


def test_sweep_step_cells_matches_reference(data, monkeypatch):
    kw = _cfg(row_block=128)
    jstep = jax.jit(jsweep_cell.make_sweep_step(JCausalConfig(**kw), E,
                                                "cells"))
    jt, js = jstep(*_jargs(data, ("X", "y", "t")),
                   jnp.asarray(data["sids"], jnp.int32))
    keys = jcolumn_keys(jax.random.PRNGKey(0), 0, E)
    table = {seed: torch.from_numpy(np.asarray(jfold_ids(
        jax.random.split(keys[s], 3)[0], N, K)).astype(np.int64))
        for s, seed in enumerate(column_keys(0, 0, E).tolist())}
    monkeypatch.setattr(engine, "cell_folds",
                        lambda seed, n, k, device=None: table[int(seed)])
    step = sweep_cell.make_sweep_step(CausalConfig(**kw), E, "cells",
                                      device="cpu")
    theta, se = step(*(data[n] for n in ("X", "y", "t", "sids")))
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), **_SWEEP_TOL)
    np.testing.assert_allclose(se.numpy(), np.asarray(js), **_SWEEP_TOL)


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_sweep_step_segmented_matches_reference(data, monkeypatch, strategy):
    kw = _cfg(row_block=128, row_block_strategy=strategy, cate_features=2)
    jstep = jax.jit(jsweep_cell.make_sweep_step(JCausalConfig(**kw), E,
                                                "segmented"))
    jt, js = jstep(*_jargs(data, ("X", "y", "t")),
                   jnp.asarray(data["sids"], jnp.int32))
    folds = torch.from_numpy(data["folds"])
    monkeypatch.setattr(segmented, "fold_ids",
                        lambda gen, n, k, device=None: folds.to(device))
    step = sweep_cell.make_sweep_step(CausalConfig(**kw), E, "segmented",
                                      device="cpu")
    theta, se = step(*(data[n] for n in ("X", "y", "t", "sids")))
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), **_SWEEP_TOL)
    np.testing.assert_allclose(se.numpy(), np.asarray(js), **_SWEEP_TOL)


def test_sweep_step_cells_bitwise_serial_loop(data):
    cfg = CausalConfig(**_cfg(row_block=128, row_block_strategy="pallas"))
    theta, se = sweep_cell.make_sweep_step(cfg, E, "cells", device="cpu")(
        *(data[n] for n in ("X", "y", "t", "sids")))
    loop = serial_loop("dml", cfg, X=data["X"], y=data["y"], t=data["t"],
                       segment_ids=data["sids"], n_segments=E, seed=0,
                       col_index=0, device="cpu")
    assert torch.equal(theta, loop["theta"]) and torch.equal(se, loop["se"])
    with pytest.raises(ValueError, match="mode"):
        sweep_cell.make_sweep_step(cfg, E, "bogus", device="cpu")


@pytest.mark.parametrize("iv", [False, True])
def test_input_specs_match_reference(iv):
    want = jdml_cell.input_specs(with_instrument=iv)
    got = dml_cell.input_specs(with_instrument=iv)
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: shape for k, (shape, _) in got.items()}
    assert (dml_cell.N_ROWS, dml_cell.N_COVARIATES) == (
        jdml_cell.N_ROWS, jdml_cell.N_COVARIATES)
    want = jsweep_cell.input_specs(n=1000, p=7)
    got = sweep_cell.input_specs(n=1000, p=7)
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: shape for k, (shape, _) in got.items()}
    assert sweep_cell.N_SEGMENTS == jsweep_cell.N_SEGMENTS
