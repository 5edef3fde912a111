"""The paper's own case study (§5.3): DML vs DML_Ray on synthetic data —
the settings of ``src/repro/configs/dml_synthetic.py``.

Scales match Figure 6: {10k, 100k, 1M} rows x ~500 covariates, binary
treatment, dowhy-style partially-linear DGP, 5-fold cross-fitting.
"""
from repro_torch.config import CausalConfig

# Paper-faithful estimator settings (EconML defaults modulo the nuisance
# family swap: ridge / logistic instead of random forests).
CAUSAL = CausalConfig(
    n_folds=5,
    nuisance_y="ridge",
    nuisance_t="logistic",
    final_stage="linear",
    cate_features=1,       # constant effect -> ATE (paper's demo)
    discrete_treatment=True,
    engine="parallel",
)

# Figure-6 sweep sizes
SCALES = (10_000, 100_000, 1_000_000)
N_COVARIATES = 500
