"""Plain PyTorch versions of the chunked gated-linear-attention (GLA)
and Mamba2 SSD scans: the counterparts of the reference's
``kernels/ssm_scan/ref.py``.

GLA covers both recurrence families:
- "post" mode (u=None):   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = q_t S_t
- "bonus" mode (RWKV-6):  o_t = q_t (S_{t-1} + diag(u) k_t v_t^T),
                          S_t = diag(w_t) S_{t-1} + k_t v_t^T

Shapes: q,k,w (B,H,T,Dk); v (B,H,T,Dv); u (H,Dk) or None; w is the
per-step decay in (0,1].  SSD: q,k (B,T,N) shared across heads;
v (B,H,T,P); a (B,H,T) a scalar decay per head.

Numerical contract (the models enforce it): ``w >= exp(-MAX_LOG_DECAY)``
per step.  The chunked GLA form factors the intra-chunk decay as
``(q·exp(cum)) @ (k·exp(-cum))^T``; ``exp(-cum)`` is bounded by
``exp(chunk · MAX_LOG_DECAY)``, ~1e24 at chunk 16, inside fp32.  The
cross-chunk flow uses only non-positive exponents.  SSD's L-matrix form
takes exponents of non-positive differences only and is stable for any
decay.

Python loops over chunks take the place of ``lax.scan``.  Everything is
computed in fp32 (fp64 for fp64 inputs, so the ``*_naive`` oracles run
in fp64 too); o is returned in v's dtype, the final state in the
working type.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import sharding

Tensor = torch.Tensor

# Per-step decay-rate bound: w >= exp(-MAX_LOG_DECAY).  The model layers
# clamp their decay parametrization to honour it (rwkv6 omega, mamba2 dt).
MAX_LOG_DECAY = 3.49


def _wt(x: Tensor) -> torch.dtype:
    """The working type: fp64 for fp64 inputs, else fp32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _readout(q: Tensor, s: Tensor) -> Tensor:
    """q (..., Dk) . s (..., Dk, Dv), both promoted to their common type
    first, as ``jnp.einsum`` promotes a bf16 q against an fp32 state."""
    dt = torch.promote_types(q.dtype, s.dtype)
    return sharding.einsum("...k,...kv->...v", q.to(dt), s.to(dt))


def gla_step(state: Tensor, q, k, v, w, u=None):
    """Single-token recurrence (decode path). state: (..., Dk, Dv).
    k v^T is formed in k's and v's dtype, and the state update and
    readout promote, as the reference's ``gla_step`` does."""
    kv = k[..., :, None] * v[..., None, :]
    if u is None:
        state = state * w[..., :, None] + kv
        o = _readout(q, state)
    else:
        o = _readout(q, state + u[..., :, None] * kv)
        state = state * w[..., :, None] + kv
    return state, o


def gla_naive(q, k, v, w, u=None, initial_state=None):
    """Token-by-token recurrence: the ground-truth oracle for tests."""
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    wt = _wt(v)
    state = (torch.zeros((B, H, Dk, Dv), dtype=wt, device=q.device)
             if initial_state is None else initial_state.to(wt))
    uu = None if u is None else u.to(wt)
    outs = []
    for t in range(T):
        state, o = gla_step(state, q[:, :, t].to(wt), k[:, :, t].to(wt),
                            v[:, :, t].to(wt), w[:, :, t].to(wt), uu)
        outs.append(o)
    return torch.stack(outs, dim=2).to(v.dtype), state


def gla_chunks(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
               u: Optional[Tensor] = None, chunk: int = 64
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The chunk-parallel part of ``gla_chunked_ref``, in the working
    type: (q_tilde (B,H,n,C,Dk), w_total (B,H,n,Dk), ks_v (B,H,n,Dk,Dv),
    o_intra (B,H,n,C,Dv)).  Chunk c reads out q_tilde_c · S_c of the
    state S_c entering it, and leaves S_{c+1} = w_total_c ⊙ S_c + ks_v_c.
    """
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    n = T // chunk
    wt = _wt(v)

    qc = q.reshape(B, H, n, chunk, Dk).to(wt)
    kc = k.reshape(B, H, n, chunk, Dk).to(wt)
    vc = v.reshape(B, H, n, chunk, Dv).to(wt)
    wc = w.reshape(B, H, n, chunk, Dk).to(wt)

    logw = torch.log(torch.clamp(wc, min=1e-22))
    cum_incl = sharding.cumsum(logw, dim=-2)             # prod_{i<=t} w_i
    cum_excl = cum_incl - logw                        # prod_{i<t}  w_i
    w_total = torch.exp(cum_incl[..., -1, :])         # (B,H,n,Dk)

    # intra-chunk pairing: bounded by the decay contract (module doc)
    k_tilde = kc * torch.exp(-cum_incl)
    # cross-chunk flow: exponent cum_last - cum <= 0, stable for any w
    k_flow = kc * torch.exp(cum_incl[..., -1:, :] - cum_incl)
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
    if u is None:  # post mode
        q_tilde = qc * torch.exp(cum_incl)
        mask = torch.tril(ones)
    else:          # bonus mode
        q_tilde = qc * torch.exp(cum_excl)
        mask = torch.tril(ones, diagonal=-1)

    scores = sharding.einsum("bhntk,bhnsk->bhnts", q_tilde, k_tilde)
    scores = torch.where(mask, scores, torch.zeros_like(scores))
    o_intra = sharding.einsum("bhnts,bhnsv->bhntv", scores, vc)
    if u is not None:
        diag = sharding.einsum("bhntk,hk,bhntk->bhnt", qc, u.to(wt), kc)
        o_intra = o_intra + diag[..., None] * vc

    ks_v = sharding.einsum("bhnsk,bhnsv->bhnkv", k_flow, vc)  # chunk summary
    return q_tilde, w_total, ks_v, o_intra


def gla_chunked_ref(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
                    u: Optional[Tensor] = None, chunk: int = 64,
                    initial_state: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Chunked-parallel scan: intra-chunk work is dense products, the
    (Dk, Dv) state carries across chunks.  Returns (o, final_state)."""
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    n = T // chunk
    wt = _wt(v)
    q_tilde, w_total, ks_v, o_intra = gla_chunks(q, k, v, w, u, chunk)

    state = (torch.zeros((B, H, Dk, Dv), dtype=wt, device=q.device)
             if initial_state is None else initial_state.to(wt))
    o_inter = []
    for c in range(n):
        o_inter.append(sharding.einsum("bhtk,bhkv->bhtv", q_tilde[:, :, c],
                                    state))
        state = w_total[:, :, c, :, None] * state + ks_v[:, :, c]
    o = o_intra + torch.stack(o_inter, dim=2)
    return o.reshape(B, H, T, Dv).to(v.dtype), state


def ssd_step(state: Tensor, q, k, v, a):
    """Single-token SSD update. state: (B,H,N,P); q,k: (B,N); v: (B,H,P);
    a: (B,H) scalar decay."""
    kv = sharding.einsum("bn,bhp->bhnp", k, v)
    state = state * a[..., None, None] + kv
    o = sharding.einsum("bn,bhnp->bhp", q, state)
    return state, o


def ssd_naive(q, k, v, a, initial_state=None):
    """Token-by-token oracle. q,k: (B,T,N); v: (B,H,T,P); a: (B,H,T)."""
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    wt = _wt(v)
    state = (torch.zeros((B, H, N, P), dtype=wt, device=q.device)
             if initial_state is None else initial_state.to(wt))
    outs = []
    for t in range(T):
        state, o = ssd_step(state, q[:, t].to(wt), k[:, t].to(wt),
                            v[:, :, t].to(wt), a[:, :, t].to(wt))
        outs.append(o)
    return torch.stack(outs, dim=2).to(v.dtype), state


def ssd_chunks(q, k, v, a, chunk: int = 64):
    """The chunk-parallel part of ``ssd_chunked_ref``, in the working
    type: (qc (B,n,C,N), q_in (B,H,n,C), a_total (B,H,n), kv_sum
    (B,H,n,N,P), o_intra (B,H,n,C,P)).  Chunk c reads out (qc_c ·
    S_c) scaled by q_in_c per head, and leaves S_{c+1} = a_total_c · S_c
    + kv_sum_c."""
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    n = T // chunk
    wt = _wt(v)

    qc = q.reshape(B, n, chunk, N).to(wt)
    kc = k.reshape(B, n, chunk, N).to(wt)
    vc = v.reshape(B, H, n, chunk, P).to(wt)
    ac = a.reshape(B, H, n, chunk).to(wt)

    loga = torch.log(torch.clamp(ac, min=1e-37))
    cum = sharding.cumsum(loga, dim=-1)                      # (B,H,n,C)
    a_total = torch.exp(cum[..., -1])                     # (B,H,n)

    # shared scores, computed once for all heads
    scores = sharding.einsum("bntk,bnsk->bnts", qc, kc)      # (B,n,C,C)
    # per-head decay L-matrix: exp of NON-POSITIVE differences (stable)
    diff = cum[..., :, None] - cum[..., None, :]          # (B,H,n,C,C)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    L = torch.where(mask, torch.exp(torch.clamp(diff, max=0.0)),
                    torch.zeros_like(diff))
    o_intra = sharding.einsum("bnts,bhnts,bhnsp->bhntp", scores, L, vc)

    # chunk kv summary with end-of-chunk decay (exponent <= 0)
    flow = torch.exp(cum[..., -1:] - cum)                 # (B,H,n,C)
    kv_sum = sharding.einsum("bnsk,bhns,bhnsp->bhnkp", kc, flow, vc)
    q_in = torch.exp(cum)                                 # (B,H,n,C)
    return qc, q_in, a_total, kv_sum, o_intra


def ssd_chunked_ref(q, k, v, a, chunk: int = 64, initial_state=None):
    """Chunked SSD scan. q,k: (B,T,N); v: (B,H,T,P); a: (B,H,T) in (0,1].
    Returns (o (B,H,T,P), final_state (B,H,N,P))."""
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    n = T // chunk
    wt = _wt(v)
    qc, q_in, a_total, kv_sum, o_intra = ssd_chunks(q, k, v, a, chunk)

    state = (torch.zeros((B, H, N, P), dtype=wt, device=q.device)
             if initial_state is None else initial_state.to(wt))
    o_inter = []
    for c in range(n):
        o_inter.append(sharding.einsum("btk,bht,bhkp->bhtp", qc[:, c],
                                    q_in[:, :, c], state))
        state = a_total[:, :, c, None, None] * state + kv_sum[:, :, c]
    o = o_intra + torch.stack(o_inter, dim=2)
    return o.reshape(B, H, T, P).to(v.dtype), state
