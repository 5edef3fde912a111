"""The orthogonal-IV case study: OrthoIV / DRIV on the compliance DGP
(``repro_torch.data.causal_dgp.make_iv_data``) — the settings of
``src/repro/configs/iv_synthetic.py``, at the DML case study's scales
so the two line up column for column.
"""
from repro_torch.config import CausalConfig

# 5-fold cross-fitting of the nuisance triple (ridge E[Y|X], logistic
# E[T|X], logistic E[Z|X]), constant CATE basis -> the LATE, bootstrap
# CIs through the task runtime.
IV_CAUSAL = CausalConfig(
    n_folds=5,
    nuisance_y="ridge",
    nuisance_t="logistic",
    nuisance_z="logistic",
    final_stage="linear",
    cate_features=1,          # constant effect -> LATE (Wald on residuals)
    discrete_treatment=True,
    discrete_instrument=True,
    iv_cov_clip=0.1,          # DRIV compliance-denominator floor
    engine="parallel",
)

# Figure-6 sweep sizes (shared with the DML case study)
SCALES = (10_000, 100_000, 1_000_000)
N_COVARIATES = 500

# Compliance rate of the synthetic encouragement design: 70% compliers
# gives a strong-but-not-trivial first stage (F >> 10 at these n).
COMPLIANCE = 0.7
