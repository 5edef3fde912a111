"""RWKV-6 "Finch" block (rwkv6-3b): attention-free time-mix with
data-dependent per-channel decay, and a squared-ReLU channel-mix.

The counterpart of the reference's ``models/rwkv.py``: the train
forward (``time_mix_train``, ``channel_mix_train``) and the serving
forms (``*_prefill``, ``*_decode``, ``rwkv_init_state``).  The time-mix
recurrence runs on the chunked GLA scan in "bonus" mode:
o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} +
k_t v_t^T, with w_t = exp(-exp(w0 + tanh(x W_a) W_b)) per channel.  The
scan takes (B, H, T, D) views of the (B, T, H, D) projections: the
Hopper kernel reads them through their strides and writes o in v's
layout, so no transpose is copied on the card.

Serving state per layer: the time-mix's GLA state ``s`` (B, H, hd, hd)
in fp32 — the scan's final state after a prefill, then one
``gla_decode_step`` per token, plain torch as in the reference — and
each mix's last input ``x_prev`` (B, 1, d) in the compute dtype, which
the token shift reads at the next step.
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

RWKV_HEADDIM = 64
DECAY_LORA = 64


def _heads(cfg: ModelConfig):
    h = max(1, cfg.d_model // RWKV_HEADDIM)
    return h, cfg.d_model // h


def time_mix_schema(cfg: ModelConfig):
    """Token-shift mixes, r/k/v/g/o projections, the decay LoRA, the
    bonus u and the per-head group norm."""
    d = cfg.d_model
    lora = min(DECAY_LORA, d)
    return {
        "mu_r": ParamDef((d,), (None,), init="zeros"),
        "mu_k": ParamDef((d,), (None,), init="zeros"),
        "mu_v": ParamDef((d,), (None,), init="zeros"),
        "mu_g": ParamDef((d,), (None,), init="zeros"),
        "mu_w": ParamDef((d,), (None,), init="zeros"),
        "wr": ParamDef((d, d), ("embed", "inner"), init="scaled"),
        "wk": ParamDef((d, d), ("embed", "inner"), init="scaled"),
        "wv": ParamDef((d, d), ("embed", "inner"), init="scaled"),
        "wg": ParamDef((d, d), ("embed", "inner"), init="scaled"),
        "wo": ParamDef((d, d), ("inner", "embed"), init="scaled"),
        "w0": ParamDef((d,), (None,), init="ones", scale=1.0),
        "w_a": ParamDef((d, lora), ("embed", None), init="scaled"),
        "w_b": ParamDef((lora, d), (None, "inner"), init="scaled", scale=0.1),
        "u": ParamDef((d,), (None,), init="zeros"),
        "ln_scale": ParamDef((d,), (None,), init="ones"),
        "ln_bias": ParamDef((d,), (None,), init="zeros"),
    }


def channel_mix_schema(cfg: ModelConfig):
    """Token-shift mixes and the squared-ReLU key/value/receptance."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), (None,), init="zeros"),
        "mu_r": ParamDef((d,), (None,), init="zeros"),
        "wk": ParamDef((d, ff), ("embed", "ff"), init="scaled"),
        "wv": ParamDef((ff, d), ("ff", "embed"), init="scaled"),
        "wr": ParamDef((d, d), ("embed", "inner"), init="scaled"),
    }


def _shift(x: Tensor, last: Optional[Tensor] = None) -> Tensor:
    """Token shift: x_{t-1}; at t=0 zeros, or ``last`` (B, 1, d), the
    input carried from the previous step."""
    if last is None:
        return pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _decay(params, xw: Tensor) -> Tensor:
    """Data-dependent per-channel decay in (0,1), fp32.  The rate
    exp(-(w0 + lora)) is clamped to MAX_LOG_DECAY per step, which bounds
    the chunked scan's exp(-cumsum) factor (ssm_scan.ref contract)."""
    lo = matmul(torch.tanh(matmul(xw.to(_F32), params["w_a"].to(_F32))),
                params["w_b"].to(_F32))
    rate = torch.clamp(torch.exp(-(params["w0"].to(_F32) + lo)),
                       max=MAX_LOG_DECAY)
    return torch.exp(-rate)


def _group_norm(cfg: ModelConfig, params, o: Tensor) -> Tensor:
    """Per-head layer norm of o (B, T, h, hd) in fp32 -> (B, T, d)."""
    B, T, h, hd = o.shape
    o = o.to(_F32)
    mu = o.mean(-1, keepdim=True)
    var = (o - mu).square().mean(-1, keepdim=True)
    o = ((o - mu) * torch.rsqrt(var + cfg.norm_eps)).reshape(B, T, h * hd)
    return o * params["ln_scale"].to(_F32) + params["ln_bias"].to(_F32)


def _tm_qkvwg(params, cfg: ModelConfig, x: Tensor, xs: Tensor):
    """r, k, v (compute dtype) and w (fp32) as (B, H, T, hd) views of
    (B, T, H, hd) tensors; u (H, hd) fp32; the gate g (B, T, d)."""
    ct = cfg.compute_dtype
    h, hd = _heads(cfg)
    B, T, _ = x.shape

    def proj(name, mu):
        return matmul(_lerp(x, xs, params[mu]), params[name].to(ct))

    def heads(t):
        return t.reshape(B, T, h, hd).transpose(1, 2)

    r, k, v = (heads(proj(n, m)) for n, m in
               (("wr", "mu_r"), ("wk", "mu_k"), ("wv", "mu_v")))
    g = proj("wg", "mu_g")
    w = heads(_decay(params, _lerp(x, xs, params["mu_w"])))
    u = params["u"].to(_F32).reshape(h, hd)
    return r, k, v, w, u, g


def _tm_out(params, cfg: ModelConfig, o: Tensor, g: Tensor,
            rules=None) -> Tensor:
    """Group norm of o (B, T, h, hd), the silu(g) gate, the projection."""
    ct = cfg.compute_dtype
    o = (_group_norm(cfg, params, o) * F.silu(g.to(_F32))).to(ct)
    return constrain(matmul(o, params["wo"].to(ct)), ("batch", "seq", "embed_act"),
                     rules)


def _whole_seq(x: Tensor, rules) -> Tensor:
    """x with its sequence whole on each rank before the scan walks its
    chunks (``ssm._whole_seq``: a sequence sharded over "model" would be
    gathered again at every chunk; XLA gathers a scanned dim once)."""
    return constrain(x, ("batch", None, "embed_act"), rules)


def time_mix_train(params, cfg: ModelConfig, x: Tensor,
                   chunk: int = 64, rules=None) -> Tensor:
    """(B, T, d) -> (B, T, d) in the compute dtype."""
    x = _whole_seq(x, rules)
    r, k, v, w, u, g = _tm_qkvwg(params, cfg, x, _shift(x))
    o, _ = scan_ops.gla(r, k, v, w, u, chunk=chunk)
    return _tm_out(params, cfg, o.transpose(1, 2), g, rules)


def time_mix_prefill(params, cfg: ModelConfig, x: Tensor, chunk: int = 64,
                     rules=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``time_mix_train`` plus the state after the last token: the
    scan's final state ``s`` (fp32) and ``x_prev`` = x[:, -1:]."""
    x = _whole_seq(x, rules)
    r, k, v, w, u, g = _tm_qkvwg(params, cfg, x, _shift(x))
    o, s_final = scan_ops.gla(r, k, v, w, u, chunk=chunk)
    return (_tm_out(params, cfg, o.transpose(1, 2), g, rules),
            {"s": s_final, "x_prev": x[:, -1:]})


def time_mix_decode(params, cfg: ModelConfig, x: Tensor,
                    state: Dict[str, Tensor], rules=None
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d); state {"s": (B, h, hd, hd), "x_prev": (B, 1, d)}.
    The readout o comes out of the step in fp32 (the reference's
    promotion), where the scan returns it in v's dtype."""
    r, k, v, w, u, g = _tm_qkvwg(params, cfg, x, state["x_prev"])
    new_s, o = scan_ops.gla_decode_step(state["s"], r[:, :, 0], k[:, :, 0],
                                        v[:, :, 0], w[:, :, 0], u)
    return (_tm_out(params, cfg, o[:, None], g, rules),
            {"s": new_s, "x_prev": x})


def channel_mix_train(params, cfg: ModelConfig, x: Tensor,
                      x_prev: Optional[Tensor] = None, rules=None) -> Tensor:
    """(B, T, d) -> (B, T, d) in the compute dtype; ``x_prev`` (B, 1, d)
    is the shift's carried input (zeros without one)."""
    ct = cfg.compute_dtype
    xs = _shift(x, x_prev)
    k = matmul(_lerp(x, xs, params["mu_k"]), params["wk"].to(ct))
    kv = matmul(torch.relu(k).square(), params["wv"].to(ct))
    r = torch.sigmoid(matmul(_lerp(x, xs, params["mu_r"]),
                              params["wr"].to(ct)))
    return constrain(r * kv, ("batch", "seq", "embed_act"), rules)


def channel_mix_prefill(params, cfg: ModelConfig, x: Tensor, rules=None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """``channel_mix_train`` plus {"x_prev": x[:, -1:]}."""
    return (channel_mix_train(params, cfg, x, rules=rules),
            {"x_prev": x[:, -1:]})


def channel_mix_decode(params, cfg: ModelConfig, x: Tensor,
                       state: Dict[str, Tensor], rules=None
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d) against {"x_prev": (B, 1, d)}."""
    return (channel_mix_train(params, cfg, x, x_prev=state["x_prev"],
                              rules=rules),
            {"x_prev": x})


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype,
                    device=None) -> Dict[str, Dict[str, Tensor]]:
    """One layer's zero state: the GLA state in fp32, the shifts'
    ``x_prev`` in ``dtype`` (the compute dtype)."""
    h, hd = _heads(cfg)
    return {"tm": {"s": torch.zeros((batch, h, hd, hd), dtype=_F32,
                                    device=device),
                   "x_prev": torch.zeros((batch, 1, cfg.d_model),
                                         dtype=dtype, device=device)},
            "cm": {"x_prev": torch.zeros((batch, 1, cfg.d_model),
                                         dtype=dtype, device=device)}}
