"""The many-cohorts sweep case study: E per-segment effect estimates per
run (``repro_torch.sweep``) on the synthetic DGP — the reference's
preset (``src/repro/configs/sweep_synthetic.py``) field for field.  The
2^20 × 500 scale of the production cell lives in
``launch/{dml,sweep}_cell.py``.
"""
from repro_torch.config import CausalConfig

# Per-cell estimator settings: DML with 5-fold cross-fitting, ridge y,
# logistic t (2·16 MM steps on the segmented path), constant CATE basis
# -> one ATE per segment.  segment_key names the cohort column in the
# caller's frame (provenance carried into EffectPanel summaries).
SWEEP = CausalConfig(
    n_folds=5,
    nuisance_y="ridge",
    nuisance_t="logistic",
    final_stage="linear",
    cate_features=1,
    discrete_treatment=True,
    engine="parallel",
    inference="none",
    segment_key="segment",
    sweep_chunk=16,
)

# The bench grid: E = 64 segments at CPU-friendly rows; the last scale is
# the paper's 2^20.
N_SEGMENTS = 64
SCALES = (16_384, 65_536, 1_048_576)
N_COVARIATES = 50
