"""repro_torch.optim — AdamW for the mlp nuisance's full-batch fits.

The reference's learning-rate schedules and gradient compression serve
LM training, which lands with the training slice (ROADMAP A.13f).
"""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     clip_by_global_norm, global_norm)
