"""The DML final stage's fused residualize -> Gram, over seg_gram.

It keeps the reference's entry point (``fit_final_stage`` and
``residual_moments`` at row_block=0 call it, as the reference does).
On the card it is the seg_gram kernel with the residual builder, the
same launch as ``seg_gram.ops.residual_gram``; once that name parity is
no longer needed it folds into ``seg_gram.ops``."""
from repro_torch.kernels.residual_gram.ops import residual_gram  # noqa: F401
