"""Attention: GQA and MLA (DeepSeek) train / prefill (dense or flash)
and decode with a KV cache.

The counterpart of the reference's ``models/attention.py`` for GQA and
MLA.  The dense path (``_sdpa``) computes what the
reference's does — scores and softmax in fp32, probabilities cast to
v's dtype before the P.V product, fp32 accumulation — and with
``ParallelConfig.use_flash_attention`` the train and prefill forward
routes through the flash-attention kernel instead
(``kernels/flash_attention``: the Hopper kernel on the card, its plain
version on the CPU), which keeps p in fp32.  Self-attention runs dense
on CPU tensors only: on the card, train and prefill self-attention go
through the kernel (or the chunked attention below) or raise.

Serving: ``gqa_prefill`` is the train forward that also returns the
layer's k / v; ``gqa_decode`` writes one token's k / v into the cache
and attends over it through ``_sdpa_decode``, a dense attention that
runs on the card (its docstring says why; ``cross_attn`` is the
other).  ``init_cache`` sizes the stacked (layers, B, S, KV, hd) cache.  RoPE is selected as the
reference selects it: interleaved pairs iff ``rope_fraction < 1`` and
the config's name starts with "chatglm", else the NeoX halves over the
rotated fraction (phi4-mini's 0.75).

MLA: ``mla_train`` is the expanded form (train and prefill: per-head k
from the latent, the shared RoPE key broadcast to every head, attention
through ``_maybe_flash`` — the flash kernel at (q.k 192, v 128) at
deepseek-v3's widths); ``mla_decode`` the weight-absorbed latent
attention over the (c_kv, k_rope) cache.  Both scale scores by
1/sqrt(qk_nope + qk_rope), with no YaRN factor, as the reference.

Cross-attention (whisper's decoder): ``cross_kv`` projects the encoder
output once, ``cross_attn`` attends over it through the dense ``_sdpa``,
unmasked and not causal, on both devices — the reference computes it
outside any Pallas kernel, with or without ``use_flash_attention``.
The encoder's bidirectional self-attention is ``gqa_train(causal=False)``
through ``_maybe_flash``.

Training: under autograd the flash route is ``fa_ops.flash_attention``'s
``autograd.Function`` on the card (the kernel's forward with its LSE
rows, the plain blocked backward) and autograd of the plain version on
the CPU.  ``attention_impl="chunked"`` is the reference's XLA
attention, ``_chunked_attn``: an online-softmax scan over key blocks of
``attention_chunk`` in fp32 with a flash-style backward
(``_FlashXLA``, whose backward is the same
``fa_ops.flash_attention_bwd_blocks``), plain torch on either device.
Its dense fallback (keys not a multiple of the chunk, one query row, a
softcap) runs on the CPU only; on the card it raises, as dense
attention does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, rmsnorm, rope_frequencies
from repro_torch.distributed.sharding import (active_mesh, constrain,
                                              einsum, matmul, rowwise,
                                              write_slot)
from repro_torch.models.params import ParamDef

Tensor = torch.Tensor
_F32 = torch.float32


def gqa_schema(cfg: ModelConfig):
    """wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"),
                           init="scaled"),
            "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                           init="scaled"),
            "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                           init="scaled"),
            "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"),
                           init="scaled")}


def mla_schema(cfg: ModelConfig):
    """MLA: the kv down-projection wkv_a (d, kvr + dr) with its norm, the
    per-head up-projections wk_b (kvr, H, dn) and wv_b (kvr, H, dv), wo
    (H, dv, d); the query through the q-LoRA wq_a (d, qr), its norm and
    wq_b (qr, H, dn + dr), or one wq (d, H, dn + dr) without it."""
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    sch = {"wkv_a": ParamDef((d, kvr + dr), ("embed", "qk_lora"),
                             init="scaled"),
           "kv_norm": ParamDef((kvr,), (None,), init="ones"),
           "wk_b": ParamDef((kvr, h, dn), ("qk_lora", "heads", "head_dim"),
                            init="scaled"),
           "wv_b": ParamDef((kvr, h, dv), ("qk_lora", "heads", "head_dim"),
                            init="scaled"),
           "wo": ParamDef((h, dv, d), ("heads", "head_dim", "embed"),
                          init="scaled")}
    if qr:
        sch["wq_a"] = ParamDef((d, qr), ("embed", "qk_lora"), init="scaled")
        sch["q_norm"] = ParamDef((qr,), (None,), init="ones")
        sch["wq_b"] = ParamDef((qr, h, dn + dr),
                               ("qk_lora", "heads", "head_dim"), init="scaled")
    else:
        sch["wq"] = ParamDef((d, h, dn + dr), ("embed", "heads", "head_dim"),
                             init="scaled")
    return sch


def attention_schema(cfg: ModelConfig):
    """The family's attention weights: MLA or GQA."""
    return mla_schema(cfg) if cfg.attention == "mla" else gqa_schema(cfg)


def _repeat_kv(x: Tensor, heads: int) -> Tensor:
    """(B, S, KV, D) -> (B, S, heads, D), each kv head repeated."""
    kv = x.shape[2]
    return x if kv == heads else torch.repeat_interleave(x, heads // kv, dim=2)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
          q_offset: int = 0, kv_mask: Optional[Tensor] = None,
          softcap: float = 0.0, rules=None) -> Tensor:
    """Dense attention.  q: (B,Sq,H,Dq) k/v: (B,Sk,KV,D*) -> (B,Sq,H,Dv).
    ``q_offset`` shifts the queries' causal positions; ``kv_mask``
    (B, Sk) marks the valid keys.  One query row that is not causal
    over grouped kv heads goes to ``_sdpa_decode``, as the reference
    routes it (whisper-smoke's cross-attention decode)."""
    B, Sq, H, Dq = q.shape
    if Sq == 1 and not causal and H != k.shape[2]:
        return _sdpa_decode(q, k, v, kv_mask=kv_mask, softcap=softcap,
                            rules=rules)
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    Sk = k.shape[1]
    # operands widened to fp32: exact products, fp32 accumulation
    scores = einsum("bqhd,bkhd->bhqk", q.to(_F32),
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
    scores = constrain(scores, ("batch", "heads", "attn_seq", "kv_seq"),
                       rules)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.to(q.dtype)


def _scale(d: int) -> float:
    """1/sqrt(d) rounded to fp32, as the reference's fp32 scalar."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=_F32)))


def _sdpa_decode(q: Tensor, k: Tensor, v: Tensor, *,
                 kv_mask: Optional[Tensor], softcap: float,
                 rules=None) -> Tensor:
    """Single-query attention over a KV cache with GROUPED heads: q
    (B, 1, H, D) is reshaped to (B, 1, KV, G, D), so the cache (B, S,
    KV, D) is never repeated to H heads.  Same arithmetic as ``_sdpa``:
    fp32 scores and softmax, p cast to v's dtype, fp32 P.V.

    A dense attention that runs on the card (``cross_attn`` is the
    other); only ``gqa_decode`` calls it.  The reference computes decode
    attention outside any Pallas kernel (``attention.py`` ``gqa_decode`` ->
    ``_sdpa`` / ``_sdpa_decode``, plain ``jnp``), so it has no kernel
    to port: per step it reads the cache once and does two products of
    one query row per head, bound by the cache's bytes.  Train and
    prefill attention never reach it: they go through ``_maybe_flash``,
    which refuses dense attention off the CPU."""
    B, Sq, H, Dq = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, KV, H // KV, Dq)
    scores = einsum("bqkgd,bskd->bkgqs", qg.to(_F32),
                          k.to(_F32)) * _scale(Dq)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, None, :], scores,
                             torch.full_like(scores, -1e30))
    scores = constrain(scores, ("batch", "kv_heads", None, None, "kv_seq"),
                       rules)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).to(_F32),
                       v.to(_F32))
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _dense_on_cpu(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  softcap: float, rules=None) -> Tensor:
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"dense attention runs on the CPU only; on {q.device} use "
            f"ParallelConfig(use_flash_attention=True) (the flash kernel)")
    return _sdpa(q, k, v, causal=causal, softcap=softcap, rules=rules)


def _chunked_attn(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  softcap: float = 0.0, chunk: int = 1024,
                  rules=None) -> Tensor:
    """The reference's ``_chunked_attn``: online-softmax attention over
    key blocks of ``chunk`` in fp32, result in q's dtype, with a
    flash-style backward that recomputes each block's probabilities
    from the saved logsumexp rows (``_FlashXLA``).  Keys not a multiple
    of the chunk, one query row or a softcap take the dense ``_sdpa``,
    as in the reference (on the CPU only)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk % chunk != 0 or Sq == 1 or softcap:
        return _dense_on_cpu(q, k, v, causal=causal, softcap=softcap,
                             rules=rules)
    if rules is not None and active_mesh() is not None:
        # on a mesh the kv heads are repeated to H, as the reference's
        # _flash_xla repeats them: the grouped (KV, G) layout cannot keep
        # q's heads sharded when KV does not divide the "model" axis
        k, v = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2])
    return _FlashXLA.apply(q.to(_F32), k.to(_F32), v.to(_F32), causal,
                           chunk, rules).to(q.dtype)


class _FlashXLA(torch.autograd.Function):
    """The reference's ``_flash_xla`` / ``_flash_xla_fwd`` /
    ``_flash_xla_bwd`` (a ``jax.custom_vjp``): q (B,Sq,H,Dq), k
    (B,Sk,KV,Dq), v (B,Sk,KV,Dv) in fp32.  The forward keeps the running
    max m, normaliser l and accumulator per query row over the key
    blocks and saves (q, k, v, out, lse = m + log(max(l, 1e-30)));
    the backward is ``fa_ops.flash_attention_bwd_blocks``.  The kv heads
    are not repeated to H: a group's G query heads are one axis."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, rules=None):
        B, Sq, H, Dq = q.shape
        Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
        G = H // KV
        sc = _scale(Dq)
        qg = q.reshape(B, Sq, KV, G, Dq).permute(0, 2, 3, 1, 4)
        kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        qi = torch.arange(Sq, device=q.device)
        # the running rows laid out as q (a DTensor's placements included)
        m = torch.full_like(qg[..., :1], -1e30,
                            memory_format=torch.contiguous_format)
        l = torch.zeros_like(m)
        acc = (torch.zeros_like(qg, memory_format=torch.contiguous_format)
               if Dv == Dq else torch.zeros_like(m).expand(
                   B, KV, G, Sq, Dv).contiguous())
        for start in range(0, Sk, chunk):
            s = einsum("bkgqd,bksd->bkgqs", qg,
                             kt[:, :, start:start + chunk]) * sc
            if causal:
                ki = torch.arange(start, start + chunk, device=q.device)
                s = torch.where(qi[:, None] >= ki[None, :], s,
                                torch.full_like(s, -1e30))
            s = constrain(s, fa_ops.grouped_score_axes(G), rules)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + einsum("bkgqs,bksd->bkgqd", p,
                                             vt[:, :, start:start + chunk])
            m = m_new
        den = torch.clamp(l, min=1e-30)
        lse = (m + torch.log(den)).reshape(B, H, Sq)
        out = (acc / den).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, chunk, rules)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, chunk, rules = ctx.args
        dq, dk, dv = fa_ops.flash_attention_bwd_blocks(
            q, k, v, out, lse, dout, causal=causal, scale=_scale(q.shape[-1]),
            chunk=chunk, rules=rules)
        return dq, dk, dv, None, None, None


def _maybe_flash(cfg: ModelConfig, parallel, q: Tensor, k: Tensor,
                 v: Tensor, *, causal: bool, rules=None) -> Tensor:
    if parallel is not None and getattr(parallel, "use_flash_attention",
                                        False):
        # on DTensors the kernel runs on each rank's (batch, heads) shard
        return rowwise(lambda q, k, v: fa_ops.flash_attention(
            q, k, v, causal=causal, softcap=cfg.logits_softcap,
            chunk=getattr(parallel, "attention_chunk", 1024)), q, k, v,
            dims=(0, 2))
    if parallel is not None and \
            getattr(parallel, "attention_impl", "dense") == "chunked":
        return _chunked_attn(q, k, v, causal=causal,
                             softcap=cfg.logits_softcap,
                             chunk=getattr(parallel, "attention_chunk", 1024),
                             rules=rules)
    return _dense_on_cpu(q, k, v, causal=causal, softcap=cfg.logits_softcap,
                         rules=rules)


def gqa_project_qkv(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                    rules=None):
    """q (B,S,H,hd), k/v (B,S,KV,hd) in the compute dtype, RoPE applied
    to ``rope_fraction`` of the head dim: interleaved pairs for chatglm's
    partial RoPE, the NeoX halves otherwise.  The selection by name is
    the reference's (``attention.py`` ``gqa_project_qkv``)."""
    ct = cfg.compute_dtype
    q = einsum("bsd,dhk->bshk", x, params["wq"].to(ct))
    k = einsum("bsd,dhk->bshk", x, params["wk"].to(ct))
    v = einsum("bsd,dhk->bshk", x, params["wv"].to(ct))
    if cfg.use_rope:
        interleaved = (cfg.rope_fraction < 1.0
                       and cfg.name.startswith("chatglm"))
        sin, cos = rope_frequencies(cfg, positions)
        q = apply_rope(q, sin, cos, interleaved)
        k = apply_rope(k, sin, cos, interleaved)
    q = constrain(q, ("batch", "attn_seq", "heads", "head_dim"), rules)
    k = constrain(k, ("batch", None, "kv_heads", "head_dim"), rules)
    v = constrain(v, ("batch", None, "kv_heads", "head_dim"), rules)
    return q, k, v


def gqa_train(params, cfg: ModelConfig, x: Tensor, parallel=None,
              causal: bool = True, rules=None) -> Tensor:
    """Self-attention over the whole sequence: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_project_qkv(params, cfg, x, positions, rules)
    out = _maybe_flash(cfg, parallel, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=causal, rules=rules)
    out = einsum("bshk,hkd->bsd", out,
                       params["wo"].to(cfg.compute_dtype))
    return constrain(out, ("batch", "seq", "embed_act"), rules)


def gqa_prefill(params, cfg: ModelConfig, x: Tensor, parallel=None,
                rules=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The causal train forward over the prompt, plus the layer's cache
    {"k", "v"} (B, S, KV, hd) in the compute dtype."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = gqa_project_qkv(params, cfg, x, positions, rules)
    out = _maybe_flash(cfg, parallel, q.contiguous(), k.contiguous(),
                       v.contiguous(), causal=True, rules=rules)
    out = einsum("bshk,hkd->bsd", out,
                       params["wo"].to(cfg.compute_dtype))
    return (constrain(out, ("batch", "seq", "embed_act"), rules),
            {"k": k, "v": v})


def gqa_decode(params, cfg: ModelConfig, x: Tensor,
               cache: Dict[str, Tensor], pos: int, rules=None
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
    q, k_new, v_new = gqa_project_qkv(params, cfg, x, positions, rules)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    at = min(max(int(pos), 0), S - 1)
    write_slot(k, at, k_new[:, 0])
    write_slot(v, at, v_new[:, 0])
    k = constrain(k, ("batch", "kv_seq", "kv_heads", "head_dim"), rules)
    v = constrain(v, ("batch", "kv_seq", "kv_heads", "head_dim"), rules)
    kv_mask = (torch.arange(S, device=x.device) <= int(pos)).expand(B, S)
    out = _sdpa_decode(q, k, v, kv_mask=kv_mask, softcap=cfg.logits_softcap,
                       rules=rules)
    out = einsum("bshk,hkd->bsd", out,
                       params["wo"].to(cfg.compute_dtype))
    return (constrain(out, ("batch", "seq", "embed_act"), rules),
            {"k": k, "v": v})


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): expanded for train / prefill, weight-absorbed latent
# attention for decode.
# ---------------------------------------------------------------------------

def _rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """The latents' RMSNorm (fp32, result in x's dtype)."""
    return rmsnorm({"scale": scale}, x, eps)


def _mla_q(params, cfg: ModelConfig, x: Tensor, positions: Tensor):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr)) in the compute dtype, RoPE
    on q_rope; through the q-LoRA and its norm where the config has one."""
    ct = cfg.compute_dtype
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        ql = matmul(x, params["wq_a"].to(ct))
        ql = _rms(ql, params["q_norm"], cfg.norm_eps)
        q = einsum("bsr,rhk->bshk", ql, params["wq_b"].to(ct))
    else:
        q = einsum("bsd,dhk->bshk", x, params["wq"].to(ct))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    sin, cos = rope_frequencies(cfg, positions, head_dim=dr)
    return q_nope, apply_rope(q_rope, sin, cos)


def _mla_latent(params, cfg: ModelConfig, x: Tensor, positions: Tensor):
    """The compressed per-token latent: c_kv (B,S,kvr), normed, and the
    shared RoPE key k_rope (B,S,dr), rotated."""
    ct = cfg.compute_dtype
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = matmul(x, params["wkv_a"].to(ct))
    c_kv = _rms(kv[..., :kvr], params["kv_norm"], cfg.norm_eps)
    sin, cos = rope_frequencies(cfg, positions, head_dim=dr)
    k_rope = apply_rope(kv[..., None, kvr:], sin, cos)[..., 0, :]
    return c_kv, k_rope


def mla_train(params, cfg: ModelConfig, x: Tensor, parallel=None,
              return_cache: bool = False, rules=None):
    """The expanded MLA forward over the whole sequence, causal:
    (B, S, d) -> (B, S, d), plus the layer's {"c_kv", "k_rope"} with
    ``return_cache`` (the prefill).  q and k are (dn + dr) wide, v dv
    wide; attention goes through ``_maybe_flash``."""
    ct = cfg.compute_dtype
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_latent(params, cfg, x, positions)
    k_nope = einsum("bsr,rhk->bshk", c_kv, params["wk_b"].to(ct))
    v = einsum("bsr,rhk->bshk", c_kv, params["wv_b"].to(ct))
    k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.num_heads,
                                            cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    q = constrain(q, ("batch", "attn_seq", "heads", "head_dim"), rules)
    k = constrain(k, ("batch", None, "heads", "head_dim"), rules)
    out = _maybe_flash(cfg, parallel, q, k, v.contiguous(), causal=True,
                       rules=rules)
    out = einsum("bshk,hkd->bsd", out, params["wo"].to(ct))
    out = constrain(out, ("batch", "seq", "embed_act"), rules)
    if return_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    return out


def mla_decode(params, cfg: ModelConfig, x: Tensor,
               cache: Dict[str, Tensor], pos: int, rules=None
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token weight-absorbed decode: x (B, 1, d); cache c_kv (B, S,
    kvr), k_rope (B, S, dr).  wk_b is absorbed into the query and wv_b
    applied to the latent context, so attention runs in the kvr-wide
    latent space over a cache of kvr + dr values a token.

    This is the reference's einsums (``attention.py`` ``mla_decode``),
    outside any Pallas kernel there, so it runs as plain tensor code on
    the card too, as ``_sdpa_decode`` does: fp32 scores (products of the
    compute-dtype operands, exact in fp32) and softmax, p cast to the
    cache's dtype, an fp32 latent context.  As ``gqa_decode``, the new
    latents are written into ``cache`` IN PLACE at the index clamped
    into [0, S - 1], and the key mask is ``arange(S) <= pos``."""
    ct = cfg.compute_dtype
    B = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.full((B, 1), int(pos), device=x.device,
                           dtype=torch.long)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)     # (B,1,H,dn/dr)
    c_new, kr_new = _mla_latent(params, cfg, x, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    at = min(max(int(pos), 0), S - 1)
    write_slot(c_kv, at, c_new[:, 0])
    write_slot(k_rope, at, kr_new[:, 0])
    c_kv = constrain(c_kv, ("batch", "kv_seq", None), rules)
    k_rope = constrain(k_rope, ("batch", "kv_seq", None), rules)
    q_lat = einsum("bqhk,rhk->bqhr", q_nope, params["wk_b"].to(ct))
    s_lat = einsum("bqhr,bsr->bhqs", q_lat.to(_F32), c_kv.to(_F32))
    s_rope = einsum("bqhk,bsk->bhqs", q_rope.to(_F32),
                          k_rope.to(_F32))
    scores = (s_lat + s_rope) * _scale(dn + dr)
    scores = constrain(scores, ("batch", "heads", None, "kv_seq"), rules)
    mask = torch.arange(S, device=x.device) <= int(pos)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = einsum("bhqs,bsr->bqhr", probs.to(c_kv.dtype).to(_F32),
                       c_kv.to(_F32))
    out = einsum("bqhr,rhk->bqhk", ctx.to(ct), params["wv_b"].to(ct))
    out = einsum("bqhk,hkd->bqd", out, params["wo"].to(ct))
    return (constrain(out, ("batch", "seq", "embed_act"), rules),
            {"c_kv": c_kv, "k_rope": k_rope})


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_kv(params, cfg: ModelConfig, enc_out: Tensor) -> Dict[str, Tensor]:
    """The cross-attention keys and values of the encoder output (B,
    T_src, d): {"k", "v"} (B, T_src, KV, hd) in the compute dtype."""
    ct = cfg.compute_dtype
    return {"k": einsum("bsd,dhk->bshk", enc_out, params["wk"].to(ct)),
            "v": einsum("bsd,dhk->bshk", enc_out, params["wv"].to(ct))}


def cross_attn(params, cfg: ModelConfig, x: Tensor,
               kv: Dict[str, Tensor], rules=None) -> Tensor:
    """The decoder's queries x (B, S, d) over the precomputed encoder
    keys and values ``kv`` (``cross_kv``): dense ``_sdpa``, every key
    valid, no softcap.  This is the one attention over a whole sequence
    that runs dense on the card: the reference runs it outside any
    Pallas kernel (``attention.py`` ``cross_attn``), so it has no kernel
    to port; its scores are (B, H, S, T_src) fp32."""
    ct = cfg.compute_dtype
    q = einsum("bsd,dhk->bshk", x, params["wq"].to(ct))
    out = _sdpa(q, kv["k"], kv["v"], causal=False)
    out = einsum("bshk,hkd->bsd", out, params["wo"].to(ct))
    return constrain(out, ("batch", "seq", "embed_act"), rules)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, n_layers: int,
               dtype=None, device=None) -> Dict[str, Tensor]:
    """Zeros of one layer stack's decode cache in ``dtype`` (the compute
    dtype by default): k / v (n_layers, batch, seq_len, KV, hd), or MLA's
    c_kv (n_layers, batch, seq_len, kvr) and k_rope (..., dr)."""
    dt = dtype or cfg.compute_dtype
    if cfg.attention == "mla":
        lead = (n_layers, batch, seq_len)
        return {"c_kv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dt,
                                    device=device),
                "k_rope": torch.zeros(lead + (cfg.qk_rope_head_dim,),
                                      dtype=dt, device=device)}
    shape = (n_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
