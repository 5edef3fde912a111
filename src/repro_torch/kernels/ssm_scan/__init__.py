"""Chunked recurrent scans: gated linear attention (RWKV-6) and Mamba2 SSD."""
from repro_torch.kernels.ssm_scan.ops import gla, gla_decode_step  # noqa: F401
