"""The estimator protocol and the registry's fit adapters
(``repro_torch.core.estimator.{CausalEstimator, fit_adapter}``, the
reference's ``repro.core.estimator``), and the sweep preset
(``repro_torch.configs.sweep_synthetic``) against the reference's.

  * every estimator facade is a ``CausalEstimator``, as the reference's
    are; a class without ``fit`` is not;
  * the registry's DML / DRLearner / OrthoIV / DRIV fits are
    ``fit_adapter``s, and each one's result is bitwise the estimator's
    own ``fit`` on the same conformance data and generator seed;
  * the preset's fields equal the reference's one by one.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import sweep_synthetic as jpreset  # noqa: E402
from repro.core.estimator import CausalEstimator as JCausalEstimator  # noqa: E402,E501
from repro.config import CausalConfig as JCausalConfig  # noqa: E402
from repro.core.dml import DML as JDML  # noqa: E402
from repro.core.drlearner import DRLearner as JDRLearner  # noqa: E402
from repro.core.iv import DRIV as JDRIV, OrthoIV as JOrthoIV  # noqa: E402
from repro_torch.configs import sweep_synthetic as preset  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.core.drlearner import DRLearner  # noqa: E402
from repro_torch.core.estimator import CausalEstimator, fit_adapter  # noqa: E402
from repro_torch.core.iv import DRIV, OrthoIV  # noqa: E402

# registry name -> (estimator class, the data columns its fit reads)
ADAPTED = {"dml": (DML, ("y", "t", "X")),
           "drlearner": (DRLearner, ("y", "t", "X")),
           "orthoiv": (OrthoIV, ("y", "t", "z", "X")),
           "driv": (DRIV, ("y", "t", "z", "X"))}


@pytest.mark.parametrize("cls,ref", [(DML, JDML), (DRLearner, JDRLearner),
                                     (OrthoIV, JOrthoIV), (DRIV, JDRIV)],
                         ids=lambda c: c.__name__)
def test_every_estimator_is_a_causal_estimator(cls, ref):
    cfg = registry.get_spec("dml").base_cfg
    assert isinstance(cls(cfg, device="cpu"), CausalEstimator)
    assert isinstance(ref(JCausalConfig()), JCausalEstimator)  # as there


def test_a_class_without_fit_is_not_an_estimator():
    @dataclasses.dataclass
    class NoFit:
        cfg: object = None

    assert not isinstance(NoFit(), CausalEstimator)


@pytest.mark.parametrize("name", sorted(ADAPTED))
def test_registry_fit_is_a_fit_adapter_bitwise_the_direct_fit(name):
    spec = registry.get_spec(name)
    cls, fields = ADAPTED[name]
    assert getattr(spec.fit, "__qualname__", "").startswith("fit_adapter")
    data = spec.make_data(0, device="cpu")
    cfg = spec.base_cfg
    got = spec.fit(data, cfg, torch.Generator().manual_seed(5))
    want = cls(cfg, device="cpu").fit(*[getattr(data, f) for f in fields],
                                      gen=torch.Generator().manual_seed(5))
    again = fit_adapter(cls, *fields)(data, cfg,
                                      torch.Generator().manual_seed(5))
    a, b, c = (registry.tree_arrays(r) for r in (got, want, again))
    assert len(a) == len(b) == len(c) > 0
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_sweep_preset_matches_reference_field_by_field():
    for f in dataclasses.fields(jpreset.SWEEP):
        assert getattr(preset.SWEEP, f.name) == getattr(jpreset.SWEEP,
                                                        f.name), f.name
    assert preset.N_SEGMENTS == jpreset.N_SEGMENTS
    assert preset.SCALES == jpreset.SCALES
    assert preset.N_COVARIATES == jpreset.N_COVARIATES
    ours = {k for k in vars(preset) if k.isupper()}
    theirs = {k for k in vars(jpreset) if k.isupper()}
    assert ours == theirs
