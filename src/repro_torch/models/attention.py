"""Attention: GQA train/prefill forward (dense or flash).

The counterpart of the reference's ``models/attention.py`` for the
dense GQA family.  The dense path (``_sdpa``) computes what the
reference's does — scores and softmax in fp32, probabilities cast to
v's dtype before the P.V product, fp32 accumulation — and with
``ParallelConfig.use_flash_attention`` the forward routes through the
flash-attention kernel instead (``kernels/flash_attention``: the
Hopper kernel on the card, its plain version on the CPU), which keeps p
in fp32.  The dense path runs on CPU tensors only: on the card,
attention goes through the kernel or raises.  MLA, decode,
cross-attention, the chunked XLA attention and partial RoPE raise
``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, rope_frequencies
from repro_torch.models.params import ParamDef

Tensor = torch.Tensor
_F32 = torch.float32


def gqa_schema(cfg: ModelConfig):
    """wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": ParamDef((d, h, hd), init="scaled"),
            "wk": ParamDef((d, kv, hd), init="scaled"),
            "wv": ParamDef((d, kv, hd), init="scaled"),
            "wo": ParamDef((h, hd, d), init="scaled")}


def attention_schema(cfg: ModelConfig):
    """The family's attention weights (GQA only in this slice)."""
    if cfg.attention == "mla":
        raise NotImplementedError(
            "MLA attention lands with the deepseek slice (ROADMAP A.13)")
    return gqa_schema(cfg)


def _repeat_kv(x: Tensor, heads: int) -> Tensor:
    """(B, S, KV, D) -> (B, S, heads, D), each kv head repeated."""
    kv = x.shape[2]
    return x if kv == heads else torch.repeat_interleave(x, heads // kv, dim=2)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
          softcap: float = 0.0) -> Tensor:
    """Dense attention.  q: (B,Sq,H,Dq) k/v: (B,Sk,KV,D*) -> (B,Sq,H,Dv)."""
    B, Sq, H, Dq = q.shape
    if Sq == 1 and not causal and H != k.shape[2]:
        raise NotImplementedError(
            "single-token decode attention lands with the serving slice "
            "(ROADMAP A.13, launch/serve.py BatchServer)")
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    Sk = k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dq), dtype=_F32))
    # operands widened to fp32: exact products, fp32 accumulation
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(_F32),
                          k.to(_F32)) * scale.to(q.device)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        qi = torch.arange(Sq, device=q.device)
        ki = torch.arange(Sk, device=q.device)
        mask = qi[:, None] >= ki[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.to(q.dtype)


def _maybe_flash(cfg: ModelConfig, parallel, q: Tensor, k: Tensor,
                 v: Tensor, *, causal: bool) -> Tensor:
    if parallel is not None and getattr(parallel, "use_flash_attention",
                                        False):
        return fa_ops.flash_attention(q, k, v, causal=causal,
                                      softcap=cfg.logits_softcap)
    if parallel is not None and \
            getattr(parallel, "attention_impl", "dense") == "chunked":
        raise NotImplementedError(
            "attention_impl='chunked' (the XLA online-softmax scan) lands "
            "with the training slice (ROADMAP A.13); use "
            "use_flash_attention=True")
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"dense attention runs on the CPU only; on {q.device} use "
            f"ParallelConfig(use_flash_attention=True) (the flash kernel)")
    return _sdpa(q, k, v, causal=causal, softcap=cfg.logits_softcap)


def gqa_project_qkv(params, cfg: ModelConfig, x: Tensor, positions: Tensor):
    """q (B,S,H,hd), k/v (B,S,KV,hd) in the compute dtype, NeoX RoPE
    applied."""
    ct = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(ct))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(ct))
    if cfg.use_rope:
        if cfg.rope_fraction < 1.0:
            raise NotImplementedError(
                "partial RoPE (phi4-mini; chatglm3's interleaved pairs) "
                "lands with those models' slices (ROADMAP A.13)")
        sin, cos = rope_frequencies(cfg, positions)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def gqa_train(params, cfg: ModelConfig, x: Tensor, parallel=None,
              causal: bool = True) -> Tensor:
    """Self-attention over the whole sequence: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    out = _maybe_flash(cfg, parallel, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=causal)
    return torch.einsum("bshk,hkd->bsd", out,
                        params["wo"].to(cfg.compute_dtype))
