"""Mamba2 (SSD) block: the zamba2 hybrid backbone.

The counterpart of the reference's ``models/ssm.py``: the train
forward (``mamba_train``) and the serving forms (``mamba_prefill``,
``mamba_decode``, ``mamba_init_state``).  The selective state-space recurrence runs on
the SSD scan: q = C and k = B shared across heads, v = dt·x per head,
and a per-head scalar decay a_t = exp(-exp(A_log)·dt_t).  The scan takes
v and a as (B, H, T, ·) views of (B, T, H, ·) tensors, which the Hopper
kernel reads through their strides.  The causal depthwise conv is plain
tensor code (the reference has no kernel for it).

Serving state per layer: the SSD state ``ssm`` (B, H, N, P) in fp32 —
the scan's final state after a prefill, then one ``ssd_decode_step`` per
token, plain torch as in the reference — and the conv's last K - 1
inputs ``conv`` (B, K-1, di) in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import MAX_LOG_DECAY
from repro_torch.distributed.sharding import constrain, matmul, pad
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
        "in_proj": ParamDef((d, 2 * di + 2 * s + heads), ("embed", "inner"),
                            init="scaled"),
        "conv_w": ParamDef((cfg.ssm_conv, di), (None, "inner"),
                           init="scaled", scale=1.0),
        "conv_b": ParamDef((di,), (None,), init="zeros"),
        "A_log": ParamDef((heads,), (None,), init="zeros"),
        "dt_bias": ParamDef((heads,), (None,), init="zeros"),
        "D": ParamDef((heads,), (None,), init="ones"),
        "norm": ParamDef((di,), (None,), init="ones"),
        "out_proj": ParamDef((di, d), ("inner", "embed"), init="scaled"),
    }


def _split_proj(cfg: ModelConfig, proj: Tensor):
    """z, xb (di each), B, C (ssm_state each), dt (heads)."""
    di, heads, _ = _dims(cfg)
    s = cfg.ssm_state
    return torch.split(proj, [di, di, s, s, heads], dim=-1)


def _causal_conv(xb: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Depthwise causal conv. xb: (B, T, di); w: (K, di); ``state``
    (B, K-1, di) the inputs before t=0 (zeros without one).  Returns
    (out, the last K-1 inputs: the next call's state; None at K = 1).
    The taps are summed in the reference's order."""
    K, T = w.shape[0], xb.shape[1]
    if state is None:
        xp = pad(xb, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(xb.dtype), xb], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b, (xp[:, -(K - 1):] if K > 1 else None)


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


def _gated_out(cfg: ModelConfig, params, y: Tensor, z: Tensor,
               rules=None) -> Tensor:
    """Gate with silu(z), RMS-normalise in fp32, project out."""
    di, _, _ = _dims(cfg)
    Bsz, T = z.shape[:2]
    y = y.reshape(Bsz, T, di).to(_F32) * F.silu(z.to(_F32))
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm"].to(_F32)
    ct = cfg.compute_dtype
    return constrain(matmul(y.to(ct), params["out_proj"].to(ct)),
                     ("batch", "seq", "embed_act"), rules)


def _skip_out(cfg: ModelConfig, params, o: Tensor, xb: Tensor,
              z: Tensor, rules=None) -> Tensor:
    """o (B, T, H, hd) plus the D skip over xb, gated and projected."""
    _, heads, hd = _dims(cfg)
    o = o + params["D"].to(_F32)[:, None] * \
        xb.reshape(*xb.shape[:2], heads, hd).to(_F32)
    return _gated_out(cfg, params, o, z, rules)


def _conv_in(cfg: ModelConfig, params, x: Tensor,
             conv_state: Optional[Tensor] = None):
    """in_proj, split, the causal conv and its silu: (z, xb, B, C, dt,
    the conv's new state)."""
    ct = cfg.compute_dtype
    z, xb, B, C, dt = _split_proj(cfg,
                                   matmul(x, params["in_proj"].to(ct)))
    xb, conv_state = _causal_conv(xb, params["conv_w"].to(ct),
                                  params["conv_b"].to(ct), conv_state)
    return z, F.silu(xb), B, C, dt, conv_state


def _whole_seq(x: Tensor, rules) -> Tensor:
    """x with its sequence whole on each rank: the chunked scan walks the
    chunks in order, and a sequence sharded over "model" (sequence
    parallelism) would be gathered again at every chunk (the reference's
    XLA gathers a scanned dim once)."""
    return constrain(x, ("batch", None, "embed_act"), rules)


def mamba_train(params, cfg: ModelConfig, x: Tensor, rules=None) -> Tensor:
    """(B, T, d) -> (B, T, d) in the compute dtype."""
    z, xb, B, C, dt, _ = _conv_in(cfg, params, _whole_seq(x, rules))
    q, k, v, a = _ssd_inputs(cfg, params, xb, B, C, dt)
    o, _ = scan_ops.ssd(q, k, v, a, chunk=max(cfg.ssm_chunk, 32))
    return _skip_out(cfg, params, o.transpose(1, 2), xb, z, rules)


def mamba_prefill(params, cfg: ModelConfig, x: Tensor, rules=None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``mamba_train`` plus the state after the last token: the scan's
    final state ``ssm`` (fp32) and the conv's last inputs ``conv``."""
    z, xb, B, C, dt, conv_state = _conv_in(cfg, params, _whole_seq(x, rules))
    q, k, v, a = _ssd_inputs(cfg, params, xb, B, C, dt)
    o, ssm_state = scan_ops.ssd(q, k, v, a, chunk=max(cfg.ssm_chunk, 32))
    return (_skip_out(cfg, params, o.transpose(1, 2), xb, z, rules),
            {"ssm": ssm_state, "conv": conv_state})


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=_F32,
                     device=None) -> Dict[str, Tensor]:
    """One layer's zero state: ``ssm`` (B, H, N, P) fp32, ``conv``
    (B, K-1, di) in ``dtype``."""
    di, heads, hd = _dims(cfg)
    return {"ssm": torch.zeros((batch, heads, cfg.ssm_state, hd),
                               dtype=_F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                                device=device)}


def mamba_decode(params, cfg: ModelConfig, x: Tensor,
                 state: Dict[str, Tensor], rules=None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d): one O(1) state update."""
    z, xb, B, C, dt, conv_state = _conv_in(cfg, params, x, state["conv"])
    q, k, v, a = _ssd_inputs(cfg, params, xb, B, C, dt)
    new_ssm, o = scan_ops.ssd_decode_step(state["ssm"], q[:, 0], k[:, 0],
                                          v[:, :, 0], a[:, :, 0])
    return (_skip_out(cfg, params, o[:, None], xb, z, rules),
            {"ssm": new_ssm, "conv": conv_state})
