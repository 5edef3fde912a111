"""Mamba2 (SSD) block: the zamba2 hybrid backbone.

The counterpart of the reference's ``models/ssm.py`` for the forward
path (``mamba_train``).  The selective state-space recurrence runs on
the SSD scan: q = C and k = B shared across heads, v = dt·x per head,
and a per-head scalar decay a_t = exp(-exp(A_log)·dt_t).  The scan takes
v and a as (B, H, T, ·) views of (B, T, H, ·) tensors, which the Hopper
kernel reads through their strides.  The causal depthwise conv is plain
tensor code (the reference has no kernel for it).  Prefill and decode
come with the serving slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import MAX_LOG_DECAY
from repro_torch.models.params import ParamDef

Tensor = torch.Tensor
_F32 = torch.float32

MAMBA_HEADDIM = 64


def _dims(cfg: ModelConfig):
    """(inner width, heads, head dim)."""
    di = cfg.ssm_expand * cfg.d_model
    heads = max(1, di // MAMBA_HEADDIM)
    return di, heads, di // heads


def mamba_schema(cfg: ModelConfig):
    """in_proj (z, x, B, C, dt), the conv, A_log, dt_bias, D, the gated
    norm and out_proj."""
    d, s = cfg.d_model, cfg.ssm_state
    di, heads, _ = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * s + heads), init="scaled"),
        "conv_w": ParamDef((cfg.ssm_conv, di), init="scaled", scale=1.0),
        "conv_b": ParamDef((di,), init="zeros"),
        "A_log": ParamDef((heads,), init="zeros"),
        "dt_bias": ParamDef((heads,), init="zeros"),
        "D": ParamDef((heads,), init="ones"),
        "norm": ParamDef((di,), init="ones"),
        "out_proj": ParamDef((di, d), init="scaled"),
    }


def _split_proj(cfg: ModelConfig, proj: Tensor):
    """z, xb (di each), B, C (ssm_state each), dt (heads)."""
    di, heads, _ = _dims(cfg)
    s = cfg.ssm_state
    return torch.split(proj, [di, di, s, s, heads], dim=-1)


def _causal_conv(xb: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv. xb: (B, T, di); w: (K, di); zeros before
    t=0.  The taps are summed in the reference's order."""
    K, T = w.shape[0], xb.shape[1]
    xp = F.pad(xb, (0, 0, K - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _ssd_inputs(cfg: ModelConfig, params, xb: Tensor, B: Tensor, C: Tensor,
                dt: Tensor):
    """SSD operands: q, k (B, T, N) shared by the heads, v (B, H, T, P)
    and a (B, H, T), all fp32; v and a are views of (B, T, H, ·)."""
    _, heads, hd = _dims(cfg)
    Bsz, T, _ = xb.shape
    dt = dt.to(_F32) + params["dt_bias"].to(_F32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))       # softplus
    # decay-rate bound: exp(A_log)·dt clamped to MAX_LOG_DECAY per step,
    # which keeps the chunked scan's exp factors finite (kernel contract)
    rate = torch.clamp(torch.exp(params["A_log"].to(_F32)) * dt,
                       max=MAX_LOG_DECAY)
    a = torch.exp(-rate)                                 # (B, T, H)
    v = (xb.reshape(Bsz, T, heads, hd) * dt[..., None].to(xb.dtype)).to(_F32)
    return C.to(_F32), B.to(_F32), v.transpose(1, 2), a.transpose(1, 2)


def _gated_out(cfg: ModelConfig, params, y: Tensor, z: Tensor) -> Tensor:
    """Gate with silu(z), RMS-normalise in fp32, project out."""
    di, _, _ = _dims(cfg)
    Bsz, T = z.shape[:2]
    y = y.reshape(Bsz, T, di).to(_F32) * F.silu(z.to(_F32))
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm"].to(_F32)
    ct = cfg.compute_dtype
    return y.to(ct) @ params["out_proj"].to(ct)


def mamba_train(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """(B, T, d) -> (B, T, d) in the compute dtype."""
    ct = cfg.compute_dtype
    _, heads, hd = _dims(cfg)
    proj = x @ params["in_proj"].to(ct)
    z, xb, B, C, dt = _split_proj(cfg, proj)
    xb = F.silu(_causal_conv(xb, params["conv_w"].to(ct),
                             params["conv_b"].to(ct)))
    q, k, v, a = _ssd_inputs(cfg, params, xb, B, C, dt)
    o, _ = scan_ops.ssd(q, k, v, a, chunk=max(cfg.ssm_chunk, 32))
    o = o.transpose(1, 2)                                # (B, T, H, hd)
    o = o + params["D"].to(_F32)[:, None] * \
        xb.reshape(*xb.shape[:2], heads, hd).to(_F32)
    return _gated_out(cfg, params, o, z)
