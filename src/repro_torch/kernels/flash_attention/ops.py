"""Dispatch for flash attention in the model's layout, and its backward.

Model code passes q (B, Sq, H, D), k (B, Sk, KV, D) and v (B, Sk, KV,
Dv); Dv differs from D in MLA's prefill.  A CUDA tensor goes to the
Hopper kernel (kernel.py), which reads that layout directly; a CPU
tensor to the plain version (ref.py), transposed to its (B, heads, S, D)
layout and back, which autograd differentiates.  Nothing else is taken,
and nothing falls back.

Under autograd on the card (grad enabled and q, k or v requiring grad)
the call is ``_FlashAttention``: its forward is the kernel asked also
for the logsumexp rows (``return_lse``), and its backward is
``flash_attention_bwd_blocks``, plain torch.  That backward is the port
of the reference's ``_flash_xla_bwd`` (``src/repro/models/attention.py``,
the custom VJP of its chunked XLA attention): the reference has no
backward Pallas kernel and cannot differentiate its Pallas forward, so
there is no TPU kernel to port here; a hand-written Hopper backward is
held speed work (ROADMAP).  ``models/attention.py``'s chunked attention
calls the same function.  Without grad the kernel runs as before,
writing no LSE.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import constrain, einsum, like
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

Tensor = torch.Tensor
_F32 = torch.float32


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    chunk: int = 1024) -> Tensor:
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv). Returns (B,Sq,H,Dv)
    in q's dtype.  ``chunk`` is the key block of the card's backward."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, softcap, scale,
                                         chunk)
        return _kernel.flash_attention_cuda(q, k, v, causal=causal,
                                            softcap=softcap, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    o = _ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           softcap=softcap, scale=scale)
    return o.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with its LSE rows saved; the plain blocked
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, scale, chunk):
        o, lse = _kernel.flash_attention_cuda(q, k, v, causal=causal,
                                              softcap=softcap, scale=scale,
                                              return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, softcap, scale, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, softcap, scale, chunk = ctx.args
        dq, dk, dv = flash_attention_bwd_blocks(
            q, k, v, o, lse, do, causal=causal, softcap=softcap,
            scale=scale, chunk=chunk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def grouped_score_axes(G: int):
    """Logical axes of grouped scores (B, KV, G, Sq, keys): with one query
    head a group (G = 1) the KV axis is the heads axis."""
    return ("batch", "heads" if G == 1 else "kv_heads", None, "attn_seq",
            None)


def flash_attention_bwd_blocks(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                               lse: Tensor, do: Tensor, *,
                               causal: bool = True, softcap: float = 0.0,
                               scale: Optional[float] = None,
                               chunk: int = 1024, rules=None
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) in fp32 of o = softmax(s) v given the forward's o and
    its logsumexp rows: the reference's ``_flash_xla_bwd``.  q (B, Sq, H,
    Dq), k (B, Sk, KV, Dq), v (B, Sk, KV, Dv), o / do (B, Sq, H, Dv), lse
    (B, H, Sq) in the units of the scaled, soft-capped scores.

    Over key blocks of ``chunk``, in fp32: the block's scores are
    recomputed and masked as the forward masked them (causal: key j of
    query i where i < j, to -1e30), p = exp(s - lse), dv = pᵀ·do,
    dp = do·vᵀ, ds = p·(dp - δ) with δ = rowsum(o·do), through the
    softcap's tanh (ds·(1 - t²), s = cap·t), times the scale; dk = dsᵀ·q,
    dq += ds·k.  The G = H / KV query heads of a group are one axis, so
    dk and dv sum over the group without repeating k or v.  A causal
    block takes only the query rows at or past its first key, and one
    wholly past the last query row contributes nothing.  ``rules``
    constrains each block's scores inside a mesh (``constrain``)."""
    B, Sq, H, Dq = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    sc = scale if scale is not None else 1.0 / math.sqrt(Dq)

    def groups(x):                      # (B, S, H, D) -> (B, KV, G, S, D)
        return x.to(_F32).reshape(B, x.shape[1], KV, G, x.shape[-1]) \
            .permute(0, 2, 3, 1, 4)

    qg, og, dog = groups(q), groups(o), groups(do)
    delta = (og * dog).sum(-1, keepdim=True)
    del og
    lse_g = lse.to(_F32).reshape(B, KV, G, Sq, 1)
    kt = k.to(_F32).permute(0, 2, 1, 3)          # (B, KV, Sk, Dq)
    vt = v.to(_F32).permute(0, 2, 1, 3)          # (B, KV, Sk, Dv)
    # the accumulators laid out as what they accumulate (a DTensor's
    # placements included)
    dq = torch.zeros_like(qg, memory_format=torch.contiguous_format)
    dk = torch.zeros_like(kt, memory_format=torch.contiguous_format)
    dv = torch.zeros_like(vt, memory_format=torch.contiguous_format)
    for start in range(0, Sk, chunk):
        end = min(start + chunk, Sk)
        r0 = start if causal else 0             # rows above see no key here
        if r0 >= Sq:
            break
        qb, dob = qg[:, :, :, r0:], dog[:, :, :, r0:]
        kb, vb = kt[:, :, start:end], vt[:, :, start:end]
        s = einsum("bkgqd,bksd->bkgqs", qb, kb) * sc
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        if causal:
            mask = (torch.arange(r0, Sq, device=q.device)[:, None]
                    >= torch.arange(start, end, device=q.device)[None, :])
            s = torch.where(mask, s, torch.full_like(s, -1e30))
        s = constrain(s, grouped_score_axes(G), rules)
        p = torch.exp(s - lse_g[:, :, :, r0:])
        del s
        dv[:, :, start:end] = like(einsum("bkgqs,bkgqd->bksd", p, dob),
                                   dv)
        dp = einsum("bkgqd,bksd->bkgqs", dob, vb)
        ds = p * (dp - delta[:, :, :, r0:])
        del p, dp
        if softcap:
            ds = ds * (1.0 - t * t)
            del t
        ds = ds * sc
        dk[:, :, start:end] = like(einsum("bkgqs,bkgqd->bksd", ds, qb),
                                   dk)
        dq[:, :, :, r0:] += like(einsum("bkgqs,bksd->bkgqd", ds, kb), dq)
        del ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dq)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)
