"""Chunked recurrent scans: gated linear attention (RWKV-6) and Mamba2 SSD."""
