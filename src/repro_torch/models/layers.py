"""Shared layers: norms, embeddings and the unembedding, RoPE, MLPs.

Each layer is a pair of (schema fn, apply fn), as in the reference's
``models/layers.py``; apply fns take the parameters as a dict (or a
``ParamTree``) and compute in the dtypes the reference computes in:
norms in fp32, products in ``cfg.compute_dtype`` with the weights cast
per call.  Large products are ``torch.matmul``/``einsum`` (through
``distributed/sharding``'s ``matmul`` / ``einsum``: the same call on
plain tensors, one local product on a DTensor's shards), as they sit
outside any Pallas kernel in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import (constrain, logsumexp_last,
                                              matmul, take_last, take_rows)
from repro_torch.models.params import ParamDef

Tensor = torch.Tensor
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_schema(d: int):
    """RMSNorm scale."""
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rmsnorm(params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm in fp32, result in x's dtype."""
    dtype = x.dtype
    x = x.to(_F32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(_F32)).to(dtype)


def layernorm_schema(d: int):
    """LayerNorm scale and bias."""
    return {"scale": ParamDef((d,), (None,), init="ones"),
            "bias": ParamDef((d,), (None,), init="zeros")}


def layernorm(params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm in fp32 (mean, variance, scale and bias), result in x's
    dtype."""
    dtype = x.dtype
    x = x.to(_F32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(_F32) + params["bias"].to(_F32)).to(dtype)


def make_norm(cfg: ModelConfig):
    """(schema fn, apply fn) of the family's norm: LayerNorm for the
    audio family (whisper), RMSNorm otherwise."""
    if cfg.family == "audio":
        return layernorm_schema, lambda p, x: layernorm(p, x, cfg.norm_eps)
    return rmsnorm_schema, lambda p, x: rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embedding_schema(cfg: ModelConfig):
    """Token table (padded vocab), untied unembed, learned positions."""
    sch = {"embedding": ParamDef((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        sch["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                                  ("embed", "vocab"), init="scaled")
    if cfg.learned_pos_emb:
        sch["pos"] = ParamDef((cfg.max_position_embeddings, cfg.d_model),
                              (None, "embed"), init="embed")
    return sch


def embed_tokens(params, cfg: ModelConfig, tokens: Tensor,
                 pos_offset: int = 0, rules=None) -> Tensor:
    """(B, S) token ids -> (B, S, d) in the compute dtype; with learned
    positions, plus ``pos[pos_offset : pos_offset + S]`` cast to the
    compute dtype."""
    ct = cfg.compute_dtype
    x = take_rows(params["embedding"], tokens.long()).to(ct)
    if cfg.learned_pos_emb:
        S = tokens.shape[-1]
        x = x + params["pos"][pos_offset:pos_offset + S].to(ct)
    return constrain(x, ("batch", "seq", "embed_act"), rules)


def unembed(params, cfg: ModelConfig, x: Tensor, rules=None) -> Tensor:
    """(..., d) -> (..., padded_vocab) logits in the compute dtype: the
    tied table's transpose or the untied ``unembed``, cast per call; the
    logits softcap; padded-vocab slots set to -1e30 (exact softmax over
    the real vocabulary)."""
    ct = cfg.compute_dtype
    w = params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    logits = matmul(x, w.to(ct))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    # vocab claims "model"; the seq dim of logits stays unsharded so the
    # (B,S,V) fp32 CE buffer shards over batch x vocab
    return constrain(logits, ("batch", "logits_seq", "vocab"), rules)


# ---------------------------------------------------------------------------
# RoPE (full / partial fraction / interleaved GLM-style)
# ---------------------------------------------------------------------------

def rope_frequencies(cfg: ModelConfig, positions: Tensor,
                     head_dim: Optional[int] = None):
    """(sin, cos), each positions.shape + (rot_dim/2,), fp32; rot_dim is
    ``rope_fraction`` of ``head_dim`` (``cfg.head_dim`` by default; MLA
    rotates its ``qk_rope_head_dim``)."""
    hd = head_dim if head_dim is not None else cfg.head_dim
    rot = int(hd * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=_F32, device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions[..., None].to(_F32) * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor,
               interleaved: bool = False) -> Tensor:
    """x: (..., heads, head_dim); sin/cos: (..., rot/2).  The rotation
    runs in fp32 (sin/cos are fp32) and is cast back to x's dtype."""
    rot = 2 * sin.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    sin = sin[..., None, :]  # add head axis
    cos = cos[..., None, :]
    if interleaved:  # GLM / GPT-J pairing: (x0,x1),(x2,x3),...
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    else:  # NeoX pairing: first half / second half
        half = rot // 2
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.cat([r1, r2], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < x.shape[-1] else out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None):
    """SwiGLU (gate, up, down) or GELU (in, out) weights, ``d_ff`` wide
    (``cfg.d_ff`` by default; deepseek's first dense layers take
    ``dense_ff``)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi_gate": ParamDef((d, ff), ("embed", "ff"), init="scaled"),
                "wi_up": ParamDef((d, ff), ("embed", "ff"), init="scaled"),
                "wo": ParamDef((ff, d), ("ff", "embed"), init="scaled")}
    return {"wi": ParamDef((d, ff), ("embed", "ff"), init="scaled"),
            "wo": ParamDef((ff, d), ("ff", "embed"), init="scaled")}


def mlp_apply(params, cfg: ModelConfig, x: Tensor, rules=None) -> Tensor:
    """The MLP in the compute dtype."""
    ct = cfg.compute_dtype
    if cfg.mlp == "swiglu":
        g = matmul(x, params["wi_gate"].to(ct))
        u = matmul(x, params["wi_up"].to(ct))
        h = F.silu(g) * u
    else:
        h = F.gelu(matmul(x, params["wi"].to(ct)), approximate="tanh")
    h = constrain(h, ("batch", "seq", "ff"), rules)
    out = matmul(h, params["wo"].to(ct))
    return constrain(out, ("batch", "seq", "embed_act"), rules)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: Tensor, labels: Tensor,
                          mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token CE in fp32: logits (B, S, V) of any float dtype,
    labels (B, S) integer ids.  With ``mask`` (B, S), the masked mean:
    Σ mask·nll / max(Σ mask, 1)."""
    logits = logits.to(_F32)
    logz = logsumexp_last(logits)
    # the difference is taken before the label axis is dropped: a
    # vocab-sharded gather is a masked partial sum that keeps its shape
    ll = take_last(logits, labels.long()[..., None])
    nll = (logz - ll)[..., 0]
    if mask is not None:
        mask = mask.to(_F32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
