"""repro_torch.optim — AdamW (the mlp nuisance's full-batch fits and LM
training), the learning-rate schedules and gradient compression."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     adamw_update_, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.compression import (ErrorFeedback,  # noqa: F401
                                           compress_decompress,
                                           compressed_psum_mean, ef_init)
from repro_torch.optim.schedule import (cosine_schedule,  # noqa: F401
                                        linear_schedule)
