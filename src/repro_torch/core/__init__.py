"""repro_torch.core — the estimation substrate: distributed Double-ML.

The paper's primary contribution on one card.  Everything bottoms out
in the moments engine (``moments``: whole, row-blocked or the
segment-Gram kernel); on top of it sit the shared estimator base layer
(``estimator``), fold-parallel cross-fitting (``crossfit``), tuning
(``tuning``), the DML / DR / metalearner / orthogonal-IV estimators, the
refutation suite and the registry (``registry``) that tests, sweeps and
the store consume.  Uncertainty quantification lives in
``repro_torch.inference``, which these modules import inside the
functions that run it, so ``repro_torch.core`` imports nothing of
``inference`` or ``runtime`` when it loads.

Re-exporting ``crossfit`` (the function) shadows the submodule of that
name, as in the reference: reach the module with
``importlib.import_module("repro_torch.core.crossfit")``.
"""
from repro_torch.core import moments  # noqa: F401
from repro_torch.core.estimator import (  # noqa: F401
    CausalEstimator, EffectResult, PseudoOutcomeEffectResult,
    SandwichEffectResult)
from repro_torch.core.dml import DML, DMLResult  # noqa: F401
from repro_torch.core.crossfit import (  # noqa: F401
    crossfit, crossfit_parallel, crossfit_parallel_loo, crossfit_sequential)
from repro_torch.core.nuisance import (  # noqa: F401
    Nuisance, make_nuisance, make_ridge, make_logistic, make_mlp)
from repro_torch.core.final_stage import cate_basis, fit_final_stage  # noqa: F401
from repro_torch.core.drlearner import DRLearner  # noqa: F401
from repro_torch.core.metalearners import (  # noqa: F401
    MetaResult, meta_bootstrap, make_meta_core, s_learner, t_learner,
    x_learner)
from repro_torch.core.iv import DRIV, OrthoIV  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    REGISTRY, EstimatorSpec, get_spec)
