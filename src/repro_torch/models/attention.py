"""Attention: GQA train / prefill (dense or flash) and decode with a
KV cache.

The counterpart of the reference's ``models/attention.py`` for the
dense GQA family.  The dense path (``_sdpa``) computes what the
reference's does — scores and softmax in fp32, probabilities cast to
v's dtype before the P.V product, fp32 accumulation — and with
``ParallelConfig.use_flash_attention`` the train and prefill forward
routes through the flash-attention kernel instead
(``kernels/flash_attention``: the Hopper kernel on the card, its plain
version on the CPU), which keeps p in fp32.  The dense path runs on CPU
tensors only: on the card, train and prefill attention go through the
kernel or raise.

Serving: ``gqa_prefill`` is the train forward that also returns the
layer's k / v; ``gqa_decode`` writes one token's k / v into the cache
and attends over it through ``_sdpa_decode``, the one dense attention
that runs on the card (its docstring says why).  ``init_cache`` sizes
the stacked (layers, B, S, KV, hd) cache.  MLA (ROADMAP A.13b),
cross-attention (A.13e), the chunked XLA attention (A.13f) and partial
RoPE (A.13a's remaining configs) raise ``NotImplementedError`` naming
their item.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
            "MLA attention lands with the deepseek slice (ROADMAP A.13b)")
    return gqa_schema(cfg)


def _repeat_kv(x: Tensor, heads: int) -> Tensor:
    """(B, S, KV, D) -> (B, S, heads, D), each kv head repeated."""
    kv = x.shape[2]
    return x if kv == heads else torch.repeat_interleave(x, heads // kv, dim=2)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
          q_offset: int = 0, kv_mask: Optional[Tensor] = None,
          softcap: float = 0.0) -> Tensor:
    """Dense attention.  q: (B,Sq,H,Dq) k/v: (B,Sk,KV,D*) -> (B,Sq,H,Dv).
    ``q_offset`` shifts the queries' causal positions; ``kv_mask``
    (B, Sk) marks the valid keys."""
    B, Sq, H, Dq = q.shape
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    Sk = k.shape[1]
    # operands widened to fp32: exact products, fp32 accumulation
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(_F32),
                          k.to(_F32)) * _scale(Dq)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        qi = torch.arange(Sq, device=q.device) + q_offset
        ki = torch.arange(Sk, device=q.device)
        mask = qi[:, None] >= ki[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -1e30))
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.to(q.dtype)


def _scale(d: int) -> float:
    """1/sqrt(d) rounded to fp32, as the reference's fp32 scalar."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=_F32)))


def _sdpa_decode(q: Tensor, k: Tensor, v: Tensor, *,
                 kv_mask: Optional[Tensor], softcap: float) -> Tensor:
    """Single-query attention over a KV cache with GROUPED heads: q
    (B, 1, H, D) is reshaped to (B, 1, KV, G, D), so the cache (B, S,
    KV, D) is never repeated to H heads.  Same arithmetic as ``_sdpa``:
    fp32 scores and softmax, p cast to v's dtype, fp32 P.V.

    This is the one dense attention that runs on the card, and only
    ``gqa_decode`` calls it.  The reference computes decode attention
    outside any Pallas kernel (``attention.py`` ``gqa_decode`` ->
    ``_sdpa`` / ``_sdpa_decode``, plain ``jnp``), so it has no kernel
    to port: per step it reads the cache once and does two products of
    one query row per head, bound by the cache's bytes.  Train and
    prefill attention never reach it: they go through ``_maybe_flash``,
    which refuses dense attention off the CPU."""
    B, Sq, H, Dq = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, KV, H // KV, Dq)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(_F32),
                          k.to(_F32)) * _scale(Dq)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, None, :], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


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
            "with the training slice (ROADMAP A.13f); use "
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
                "lands with those models' configs (ROADMAP A.13a)")
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


def gqa_prefill(params, cfg: ModelConfig, x: Tensor, parallel=None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The causal train forward over the prompt, plus the layer's cache
    {"k", "v"} (B, S, KV, hd) in the compute dtype."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    out = _maybe_flash(cfg, parallel, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=True)
    out = torch.einsum("bshk,hkd->bsd", out,
                       params["wo"].to(cfg.compute_dtype))
    return out, {"k": k, "v": v}


def gqa_decode(params, cfg: ModelConfig, x: Tensor,
               cache: Dict[str, Tensor], pos: int
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode.  x: (B, 1, d); cache k / v: (B, S, KV, hd);
    ``pos`` the index the new token is written at (the cache holds the
    positions before it), and its RoPE position for every row.

    The new k / v are written into ``cache`` IN PLACE, and the same
    tensors are returned.  As ``lax.dynamic_update_slice`` does in the
    reference, the write index is clamped into [0, S - 1]; the key mask
    is ``arange(S) <= pos`` unclamped."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), device=x.device,
                           dtype=torch.long)
    q, k_new, v_new = gqa_project_qkv(params, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    at = min(max(int(pos), 0), S - 1)
    k[:, at] = k_new[:, 0]
    v[:, at] = v_new[:, 0]
    kv_mask = (torch.arange(S, device=x.device) <= int(pos)).expand(B, S)
    out = _sdpa_decode(q, k, v, kv_mask=kv_mask, softcap=cfg.logits_softcap)
    out = torch.einsum("bshk,hkd->bsd", out,
                       params["wo"].to(cfg.compute_dtype))
    return out, {"k": k, "v": v}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, n_layers: int,
               dtype=None, device=None) -> Dict[str, Tensor]:
    """Zeros of one layer stack's decode cache: k / v (n_layers, batch,
    seq_len, KV, hd) in ``dtype`` (the compute dtype by default)."""
    if cfg.attention == "mla":
        raise NotImplementedError(
            "MLA's latent cache lands with the deepseek slice "
            "(ROADMAP A.13b)")
    shape = (n_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
