"""Flash attention (FA-2 forward): GQA, causal, optional tanh softcap."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
