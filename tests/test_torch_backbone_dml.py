"""The slice as a whole: LM-backbone features -> standardize -> DML fit
+ delete-fold jackknife, the port against the JAX package, for the
dense (granite-3-2b-smoke), rwkv6 (rwkv6-3b-smoke) and hybrid
(zamba2-1.2b-smoke) backbones.

  * ``backbone_features`` (batched) -> standardize -> ``DML.fit`` against
    ``repro.core.nuisance.backbone_features`` -> ``repro.core.dml.DML``
    at each smoke backbone with ``use_flash_attention=True`` on both
    sides: the same weights (``convert.model_params``), the same tokens,
    y and t (made with numpy) and the reference's fold ids; features,
    theta, the HC0 cov and the jackknife se are compared;
  * ``make_nuisance("backbone", ...)`` gives the ridge / logistic heads;
  * ``make_event_data``'s distribution: the share of the special token
    tracks engagement, treatment is confounded by it, and least squares
    on (1, t, e) recovers the outcome model's (2, 4).

The reference runs its whole-array moments (row_block=0) and the port
its blocked path (row_block=128, strategy "pallas": the plain version
on the CPU); the two agree to fp32 reassociation.  Tolerances:
standardized features and theta, cov and jackknife se rtol 1e-4 with
atol 1e-4·max|x| — the slice-1 DML tolerance (16 fp32 Newton steps and
two frameworks' reassociation), now over 64 standardized features.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.dml import DML as JDML  # noqa: E402
from repro.core.nuisance import backbone_features as jbackbone  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import CausalConfig, ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
# the submodule, not the ``crossfit`` function ``repro_torch.core`` re-exports
tcf = importlib.import_module("repro_torch.core.crossfit")
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.nuisance import backbone_features, make_nuisance  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

_ARCH = "granite-3-2b-smoke"
_N, _S = 400, 32


def _close(got, want, tol, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _standardize(f):
    return (f - f.mean(0)) / (f.std(0, correction=0) + 1e-6)


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(11)
    e = rng.random(_N).astype(np.float32)
    special = rng.random((_N, _S)) < e[:, None]
    tokens = np.where(special, 7, rng.integers(8, 256, (_N, _S)))
    tokens = tokens.astype(np.int32)
    t = (rng.random(_N) < 1 / (1 + np.exp(-3 * (e - 0.5)))).astype(np.float32)
    y = (2 * t + 4 * e + 0.5 * rng.standard_normal(_N)).astype(np.float32)
    return tokens, y, t


def test_backbone_dml_matches_reference(scenario, monkeypatch):
    _backbone_dml_matches_reference(_ARCH, scenario, monkeypatch)


@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "zamba2-1.2b-smoke"])
def test_recurrent_backbone_dml_matches_reference(arch, scenario,
                                                  monkeypatch):
    """The same slice through the rwkv6 (GLA scan) and zamba2 (SSD scan
    and the shared attention block) smoke backbones."""
    _backbone_dml_matches_reference(arch, scenario, monkeypatch)


def _backbone_dml_matches_reference(arch, scenario, monkeypatch):
    tokens, y, t = scenario
    kw = dict(n_folds=5, nuisance_y="backbone", nuisance_t="backbone",
              engine="parallel", inference="jackknife")
    port_kw = dict(kw, row_block=128, row_block_strategy="pallas")
    jmodel = build_model(jget_config(arch),
                         JParallelConfig(use_flash_attention=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    jf = jbackbone(jmodel, params, jnp.asarray(tokens), batch_size=200)
    jf = (jf - jf.mean(0)) / (jf.std(0) + 1e-6)
    jres = JDML(JCausalConfig(**kw)).fit(jnp.asarray(y), jnp.asarray(t), jf,
                                         key=jax.random.PRNGKey(0))

    cfg = get_config(arch)
    model = Model(cfg, ParallelConfig(use_flash_attention=True), device="cpu")
    model.load_state_dict(convert.model_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    feats = backbone_features(model, torch.from_numpy(tokens), batch_size=200)
    assert feats.shape == (_N, cfg.d_model)
    tf = _standardize(feats.double()).float()
    _close(tf.numpy(), np.asarray(jf), 1e-4, "standardized features")

    folds = convert.folds(jres.crossfit.folds, device="cpu")
    monkeypatch.setattr(tcf, "fold_ids", lambda gen, n, k, device=None:
                        folds.to(device))
    res = DML(CausalConfig(**port_kw), device="cpu").fit(
        torch.from_numpy(y), torch.from_numpy(t), tf)
    _close(res.theta.numpy(), np.asarray(jres.theta), 1e-4, "theta")
    _close(res.cov.numpy(), np.asarray(jres.cov), 1e-4, "HC0 cov")
    _close(res.inference().se.numpy(), np.asarray(jres.inference().se),
           1e-4, "jackknife se")


def test_batched_features_equal_one_batch(scenario):
    cfg = get_config(_ARCH)
    model = Model(cfg, ParallelConfig(use_flash_attention=True), device="cpu",
                  seed=2)
    tok = torch.from_numpy(scenario[0][:40])
    whole = backbone_features(model, tok)
    parts = backbone_features(model, tok, batch_size=16)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_backbone_nuisance_is_the_linear_heads():
    cfg = CausalConfig()
    assert make_nuisance("backbone", "reg", cfg).name == "ridge"
    assert make_nuisance("backbone", "clf", cfg).name == "logistic"


def test_event_data_distribution():
    from repro_torch.data.event_dgp import make_event_data

    d = make_event_data(3000, 64, 256, seed=5, device="cpu")
    assert d.tokens.shape == (3000, 64) and d.tokens.dtype == torch.int64
    assert int(d.tokens.min()) >= 7 and int(d.tokens.max()) < 256
    share = (d.tokens == 7).float().mean(1)
    assert float((share - d.engagement).abs().mean()) < 0.06
    assert set(d.t.unique().tolist()) <= {0.0, 1.0} and d.true_ate == 2.0
    # engagement confounds: the treated are more engaged
    assert float(d.engagement[d.t == 1].mean()
                 - d.engagement[d.t == 0].mean()) > 0.1
    # y = 2t + 4e + 0.5 eps, recovered by least squares on (1, t, e)
    A = torch.stack([torch.ones(3000), d.t, d.engagement], 1).double()
    coef = torch.linalg.lstsq(A, d.y.double()[:, None]).solution[:, 0]
    np.testing.assert_allclose(coef[1:].numpy(), [2.0, 4.0], atol=0.1)
