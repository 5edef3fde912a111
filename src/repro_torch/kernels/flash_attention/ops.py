"""Dispatch for flash attention in the model's layout.

Model code passes q (B, Sq, H, D), k (B, Sk, KV, D) and v (B, Sk, KV,
Dv); Dv differs from D in MLA's prefill.  A CUDA
tensor goes to the Hopper kernel (kernel.py), which reads that layout
directly; a CPU tensor to the plain version (ref.py), transposed to its
(B, heads, S, D) layout and back.  Nothing else is taken, and nothing
falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv). Returns (B,Sq,H,Dv)
    in q's dtype."""
    if q.device.type == "cuda":
        return _kernel.flash_attention_cuda(q, k, v, causal=causal,
                                            softcap=softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    o = _ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           softcap=softcap, scale=scale)
    return o.transpose(1, 2)
