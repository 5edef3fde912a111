"""Plain PyTorch version of flash attention: the counterpart of the
reference's ``kernels/flash_attention/ref.py:attention_ref``.

Everything in fp32 (fp64 for fp64 inputs): scores, softmax, the P.V
product; the result cast to q's dtype — the function the kernel computes, with the whole score
matrix in memory.  CPU tensors take it; the tests and ``chip_smoke.py``
hold the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import einsum

Tensor = torch.Tensor
_F32 = torch.float32


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  softcap: float = 0.0,
                  scale: Optional[float] = None) -> Tensor:
    """q, k: (B,H,Sq,D), (B,KV,Sk,D); v: (B,KV,Sk,Dv); H % KV == 0.
    Returns (B,H,Sq,Dv); the default scale is 1/sqrt(D)."""
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    wt = torch.float64 if q.dtype == torch.float64 else _F32
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, KV, G, Sq, D).to(wt)
    s = einsum("bkgqd,bksd->bkgqs", qg, k.to(wt)) * sc
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = einsum("bkgqs,bksd->bkgqd", p, v.to(wt))
    return o.reshape(B, H, Sq, Dv).to(q.dtype)


def attention_lse(q: Tensor, k: Tensor, *, causal: bool = True,
                  softcap: float = 0.0,
                  scale: Optional[float] = None) -> Tensor:
    """Each query row's logsumexp of its scaled, soft-capped, masked
    scores in fp32 (fp64 for fp64 inputs): what the kernel writes with
    ``return_lse``.  q (B,H,Sq,D), k (B,KV,Sk,D) -> (B,H,Sq)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    wt = torch.float64 if q.dtype == torch.float64 else _F32
    sc = scale if scale is not None else 1.0 / (D ** 0.5)
    s = einsum("bkgqd,bksd->bkgqs",
                     q.reshape(B, KV, H // KV, Sq, D).to(wt), k.to(wt)) * sc
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
