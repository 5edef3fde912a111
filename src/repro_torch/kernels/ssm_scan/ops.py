"""Dispatch for the chunked scans.

``gla`` and ``ssd`` take the reference's layouts (``ssm_scan/ops.py``)
and its chunk rule: ``chunk`` is halved until it divides T.  A CUDA
tensor goes to the Hopper kernel (kernel.py), a CPU tensor to the plain
chunked version (ref.py).  Nothing else is taken, and nothing falls back.

Under autograd (grad enabled and an input requiring grad) the call is
``_GLAScan`` / ``_SSDScan`` on either device: the forward is the route
above (the kernel on the card, the plain chunked scan on the CPU), and
the one backward is ``gla_bwd_chunks`` / ``ssd_bwd_chunks``, plain
torch in fp32.  They compute the cotangents of the plain chunked scans,
the reference's ``gla_chunked_ref`` / ``ssd_chunked_ref``, which
``jax.grad`` differentiates in the reference: its Pallas scans have no
backward, so there is no TPU kernel to port here, and a hand-written
Hopper backward is held speed work (ROADMAP).  Only the inputs are
saved; the backward recomputes the chunk-boundary states from them.
Without grad the calls are the routes above, unchanged.

``gla_decode_step`` and ``ssd_decode_step`` (serving: one new token
against the recurrent state a prefill's scan left) are plain torch on
both devices, as they are plain ``jnp`` in the reference
(``ssm_scan/ops.py``): per head, one rank-1 update of the (Dk, Dv)
state and one readout, a few hundred bytes of state read and written
per product — bound by memory, with nothing for a tiled kernel to
reuse.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import einsum, whole_dim
from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref

Tensor = torch.Tensor


def _fit_chunk(chunk: int, T: int) -> int:
    while chunk > 1 and T % chunk:
        chunk //= 2
    return chunk


def _device(x: Tensor, what: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return x.device.type


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def gla(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
        u: Optional[Tensor] = None, *, chunk: int = 64
        ) -> Tuple[Tensor, Tensor]:
    """Gated-linear-attention scan; see ssm_scan.ref for semantics.
    q,k,w (B,H,T,Dk); v (B,H,T,Dv); u (H,Dk) or None."""
    chunk = _fit_chunk(chunk, q.shape[2])
    _device(q, "gla")
    if _wants_grad(q, k, v, w, u):
        return _GLAScan.apply(q, k, v, w, u, chunk)
    return _gla_forward(q, k, v, w, u, chunk)


def ssd(q: Tensor, k: Tensor, v: Tensor, a: Tensor, *, chunk: int = 32
        ) -> Tuple[Tensor, Tensor]:
    """Mamba2 SSD scan. q,k (B,T,N); v (B,H,T,P); a (B,H,T)."""
    chunk = _fit_chunk(chunk, q.shape[1])
    _device(q, "ssd")
    if _wants_grad(q, k, v, a):
        return _SSDScan.apply(q, k, v, a, chunk)
    return _ssd_forward(q, k, v, a, chunk)


def _gla_forward(q, k, v, w, u, chunk):
    if q.device.type == "cuda":
        return _kernel.gla_cuda(q, k, v, w, u, chunk=chunk)
    return _ref.gla_chunked_ref(q, k, v, w, u, chunk=chunk)


def _ssd_forward(q, k, v, a, chunk):
    if q.device.type == "cuda":
        return _kernel.ssd_cuda(q, k, v, a, chunk=chunk)
    return _ref.ssd_chunked_ref(q, k, v, a, chunk=chunk)


def _cast_grads(ctx, grads, inputs):
    """Each gradient in its input's dtype, None where none is needed."""
    return tuple(g.to(x.dtype) if g is not None and need else None
                 for g, x, need in zip(grads, inputs, ctx.needs_input_grad))


class _GLAScan(torch.autograd.Function):
    """The device's forward (run without grad); ``gla_bwd_chunks``."""

    @staticmethod
    def forward(ctx, q, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, w, u)
        ctx.chunk = chunk
        return _gla_forward(q, k, v, w, u, chunk)

    @staticmethod
    def backward(ctx, do, ds):
        q, k, v, w, u = ctx.saved_tensors
        grads = gla_bwd_chunks(q, k, v, w, u, do, ds, ctx.chunk)
        return _cast_grads(ctx, grads, (q, k, v, w, u)) + (None,)


class _SSDScan(torch.autograd.Function):
    """The device's forward (run without grad); ``ssd_bwd_chunks``."""

    @staticmethod
    def forward(ctx, q, k, v, a, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, a)
        ctx.chunk = chunk
        return _ssd_forward(q, k, v, a, chunk)

    @staticmethod
    def backward(ctx, do, ds):
        q, k, v, a = ctx.saved_tensors
        grads = ssd_bwd_chunks(q, k, v, a, do, ds, ctx.chunk)
        return _cast_grads(ctx, grads, (q, k, v, a)) + (None,)


def _leaves(wt, *xs):
    return [None if x is None else x.detach().to(wt).requires_grad_()
            for x in xs]


def _carry(decay, x, last=None, reverse=False):
    """The inter-chunk recurrence over n chunks, chunk-major (n, ...):
    forward, S_0 = 0 and S_c = decay_{c-1} ⊙ S_{c-1} + x_{c-1} (the
    states entering the chunks); reverse, D_{n-1} = ``last`` (0 for
    None) and D_{c-1} = decay_c ⊙ D_c + x_c.  ``decay`` broadcasts
    against one chunk's state."""
    n = x.shape[0]
    decay, x = whole_dim(decay, 0), whole_dim(x, 0)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    first = n - 1 if reverse else 0
    if last is None:
        out[first].zero_()
    else:
        out[first].copy_(last)
    for c in range(1, n):
        src, dst = (n - c, n - c - 1) if reverse else (c - 1, c)
        torch.addcmul(x[src], decay[src], out[src], out=out[dst])
    return out


def gla_bwd_chunks(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
                   u: Optional[Tensor], do: Optional[Tensor],
                   ds_final: Optional[Tensor], chunk: int
                   ) -> Tuple[Optional[Tensor], ...]:
    """(dq, dk, dv, dw, du) in the working type (fp32; fp64 for fp64
    inputs) of ``ref.gla_chunked_ref(q, k, v, w, u, chunk)`` with no
    initial state, given the cotangents ``do`` of o and ``ds_final`` of
    the final state (None for zero); du is None where u is.

    (a) The chunk-parallel part (``ref.gla_chunks``: the clamped logs,
    cumsums and exps, q̃, k̃, k_flow, the masked scores, o_intra with the
    bonus diagonal through u, w_total and the chunk summaries ks_v) is
    rebuilt from the inputs as one graph.  (b) The states entering the
    chunks, S_c, are recomputed by the plain inter-chunk recurrence, and
    the recurrence is walked backward: D_c = dL/dS_{c+1}, D_{n-1} =
    ds_final, D_{c-1} = w_total_c ⊙ D_c + q̃_cᵀ·do_c.  That gives dq̃_c
    += do_c·S_cᵀ, d(ks_v)_c = D_c and d(w_total)_c = Σ_v D_c ⊙ S_c.
    (c) One ``torch.autograd.grad`` pulls those and ``do`` (o_intra's)
    through the graph of (a).  S, D and q̃ᵀ·do are (B, H, n, Dk, Dv)
    each, one call's worth at a time."""
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    n = T // chunk
    wt = _ref._wt(v)
    leaves = _leaves(wt, q, k, v, w, u)
    with torch.enable_grad():
        q_tilde, w_total, ks_v, o_intra = _ref.gla_chunks(*leaves, chunk)
    with torch.no_grad():
        dec = w_total.detach().permute(2, 0, 1, 3)[..., None]   # (n,B,H,Dk,1)
        S = _carry(dec, ks_v.detach().permute(2, 0, 1, 3, 4))
        do_c = (torch.zeros_like(o_intra) if do is None else
                do.to(wt).reshape(B, H, n, chunk, Dv))
        dq_tilde = einsum("bhntv,nbhkv->bhntk", do_c, S)
        G = einsum("bhntk,bhntv->nbhkv", q_tilde.detach(), do_c)
        D = _carry(dec, G, None if ds_final is None else ds_final.to(wt),
                   reverse=True)
        del G
        dw_total = einsum("nbhkv,nbhkv->bhnk", D, S)
        del S
    outs = [o_intra, q_tilde, w_total, ks_v]
    cots = [do_c, dq_tilde, dw_total, D.permute(1, 2, 0, 3, 4)]
    got = iter(torch.autograd.grad(outs, [x for x in leaves if x is not None],
                                   cots))
    return tuple(None if x is None else next(got) for x in leaves)


def ssd_bwd_chunks(q: Tensor, k: Tensor, v: Tensor, a: Tensor,
                   do: Optional[Tensor], ds_final: Optional[Tensor],
                   chunk: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dq, dk, dv, da) in the working type of ``ref.ssd_chunked_ref(q,
    k, v, a, chunk)`` with no initial state, given ``do`` and
    ``ds_final`` (None for zero).  As ``gla_bwd_chunks``, over
    ``ref.ssd_chunks`` (the clamped log, cumsum, the L-matrix, the
    shared scores, o_intra, flow, kv_sum, q_in): the readout of chunk c
    is q_in_c ⊙ (qc_c · S_c), so with m_c = do_c · S_cᵀ (per head) the
    walk gives d(qc)_c += Σ_h q_in_c ⊙ m_c, d(q_in)_c = Σ_N qc_c ⊙ m_c,
    D_{c-1} = a_total_c · D_c + (q_in_c ⊙ qc_c)ᵀ·do_c, d(kv_sum)_c = D_c
    and d(a_total)_c = Σ D_c ⊙ S_c."""
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    n = T // chunk
    wt = _ref._wt(v)
    leaves = _leaves(wt, q, k, v, a)
    with torch.enable_grad():
        qc, q_in, a_total, kv_sum, o_intra = _ref.ssd_chunks(*leaves, chunk)
    with torch.no_grad():
        dec = a_total.detach().permute(2, 0, 1)[..., None, None]
        S = _carry(dec, kv_sum.detach().permute(2, 0, 1, 3, 4))
        do_c = (torch.zeros_like(o_intra) if do is None else
                do.to(wt).reshape(B, H, n, chunk, P))
        m = einsum("bhntp,nbhkp->bhntk", do_c, S)
        qd, qi = qc.detach(), q_in.detach()
        dqc = einsum("bhntk,bhnt->bntk", m, qi)
        dq_in = einsum("bhntk,bntk->bhnt", m, qd)
        del m
        G = einsum("bntk,bhntp->nbhkp", qd, do_c * qi[..., None])
        D = _carry(dec, G, None if ds_final is None else ds_final.to(wt),
                   reverse=True)
        del G
        da_total = einsum("nbhkp,nbhkp->bhn", D, S)
        del S
    outs = [o_intra, qc, q_in, a_total, kv_sum]
    cots = [do_c, dqc, dq_in, da_total, D.permute(1, 2, 0, 3, 4)]
    return tuple(torch.autograd.grad(outs, leaves, cots))


def gla_decode_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                    w: Tensor, u: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """One token of the GLA recurrence: state (B, H, Dk, Dv) fp32;
    q, k, w (B, H, Dk); v (B, H, Dv); u (H, Dk) or None.  Returns
    (new state, o (B, H, Dv)); mixed dtypes promote as in the
    reference (a bf16 q against the fp32 state reads out in fp32)."""
    return _ref.gla_step(state, q, k, v, w, u)


def ssd_decode_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                    a: Tensor) -> Tuple[Tensor, Tensor]:
    """One token of the SSD recurrence: state (B, H, N, P); q, k (B, N);
    v (B, H, P); a (B, H).  Returns (new state, o (B, H, P))."""
    return _ref.ssd_step(state, q, k, v, a)
