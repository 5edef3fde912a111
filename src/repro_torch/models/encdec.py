"""Whisper-style encoder-decoder (whisper-tiny).

The counterpart of the reference's ``models/encdec.py``.  The conv/mel
front end is a stub, as in the reference: the caller hands in
precomputed frame embeddings (B, T_src, d_model), the output of the two
strided convolutions.  Everything after it is the model: learned source
positions, the bidirectional encoder, the causal decoder with one
cross-attention per layer, LayerNorm throughout.

A Python loop over the stacked layer axis takes the place of
``lax.scan``, as in ``transformer.DecoderStack``; under autograd each
encoder and decoder layer runs under ``transformer.remat`` with
``parallel.remat_policy``, as the reference scans them.  Each layer is one
function per form (``encoder_layer``; ``decoder_layer_train`` /
``_prefill`` / ``_decode``), and the stack functions walk them.  The
encoder's self-attention is ``gqa_train(causal=False)``, through
``_maybe_flash`` (the flash kernel, bidirectional, on the card); the
decoder's self-attention is causal through the same route, and its
cross-attention is the dense ``attention.cross_attn`` on both devices.
Caches are stacked on a leading decoder-layer axis: self {"k", "v"}
(L, B, S, KV, hd) and cross {"k", "v"} (L, B, T_src, KV, hd).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models.layers import (layernorm, layernorm_schema,
                                      mlp_apply, mlp_schema)
from repro_torch.models.params import (ParamDef, layer_list, layer_slice,
                                       stack_schema)
from repro_torch.models.transformer import remat

Tensor = torch.Tensor
KV = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def encoder_schema(cfg: ModelConfig):
    """Learned source positions (max_source_positions, d), the stacked
    encoder layers (ln1, attn, ln2, mlp) and the final LayerNorm."""
    d = cfg.d_model
    layer = {"ln1": layernorm_schema(d), "attn": attn.gqa_schema(cfg),
             "ln2": layernorm_schema(d), "mlp": mlp_schema(cfg)}
    return {"pos": ParamDef((cfg.max_source_positions, d), (None, "embed"),
                            init="embed"),
            "layers": stack_schema(layer, cfg.encoder_layers),
            "ln_f": layernorm_schema(d)}


def decoder_layer_schema(cfg: ModelConfig):
    """One decoder layer: ln1, self, ln2, cross, ln3, mlp."""
    d = cfg.d_model
    return {"ln1": layernorm_schema(d), "self": attn.gqa_schema(cfg),
            "ln2": layernorm_schema(d), "cross": attn.gqa_schema(cfg),
            "ln3": layernorm_schema(d), "mlp": mlp_schema(cfg)}


def _ln(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    return layernorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encoder_layer(lp, cfg: ModelConfig, h: Tensor, parallel=None,
                  rules=None) -> Tensor:
    """Pre-norm bidirectional self-attention, then the MLP."""
    h = h + attn.gqa_train(lp["attn"], cfg, _ln(lp["ln1"], h, cfg),
                           parallel, causal=False, rules=rules)
    return h + mlp_apply(lp["mlp"], cfg, _ln(lp["ln2"], h, cfg), rules)


def encode(params, cfg: ModelConfig, frames: Tensor,
           parallel=None, rules=None) -> Tensor:
    """frames (B, T_src, d_model), the post-conv stub embeddings ->
    the encoder output (B, T_src, d_model) in the compute dtype."""
    ct = cfg.compute_dtype
    x = frames.to(ct) + params["pos"][:frames.shape[1]].to(ct)
    x = constrain(x, ("batch", "seq", "embed_act"), rules)
    for lp in layer_list(params["layers"]):
        x = remat(_policy(parallel), encoder_layer, lp, cfg, x, parallel,
                  rules)
    return _ln(params["ln_f"], x, cfg)


def _policy(parallel) -> str:
    return parallel.remat_policy if parallel is not None else "nothing"


def encoder_cross_kv(params, cfg: ModelConfig, enc_out: Tensor) -> KV:
    """Every decoder layer's cross-attention keys and values of the
    encoder output, stacked: {"k", "v"} (L, B, T_src, KV, hd).
    ``params`` is the stacked decoder-layer tree."""
    per = [attn.cross_kv(layer_slice(params["cross"], i), cfg, enc_out)
           for i in range(cfg.num_layers)]
    return {n: torch.stack([kv[n] for kv in per]) for n in ("k", "v")}


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_mlp(lp, cfg: ModelConfig, h: Tensor, kv: KV,
               rules=None) -> Tensor:
    """The layer's cross-attention and MLP halves over h."""
    h = h + attn.cross_attn(lp["cross"], cfg, _ln(lp["ln2"], h, cfg), kv,
                            rules)
    return h + mlp_apply(lp["mlp"], cfg, _ln(lp["ln3"], h, cfg), rules)


def decoder_layer_train(lp, cfg: ModelConfig, h: Tensor, enc_out: Tensor,
                        parallel=None, rules=None) -> Tensor:
    """Causal self-attention, cross-attention over the encoder output
    (its keys and values projected here, as the reference's train body
    does), then the MLP."""
    h = h + attn.gqa_train(lp["self"], cfg, _ln(lp["ln1"], h, cfg),
                           parallel, causal=True, rules=rules)
    return _cross_mlp(lp, cfg, h, attn.cross_kv(lp["cross"], cfg, enc_out),
                      rules)


def decoder_layer_prefill(lp, cfg: ModelConfig, h: Tensor, kv: KV,
                          parallel=None, rules=None) -> Tuple[Tensor, KV]:
    """``decoder_layer_train`` over the precomputed cross ``kv``, plus
    the layer's self-attention cache."""
    a, cache = attn.gqa_prefill(lp["self"], cfg, _ln(lp["ln1"], h, cfg),
                                parallel, rules)
    return _cross_mlp(lp, cfg, h + a, kv, rules), cache


def decoder_layer_decode(lp, cfg: ModelConfig, h: Tensor, cache: KV,
                         kv: KV, pos: int, rules=None) -> Tuple[Tensor, KV]:
    """One token against the layer's self cache (written in place) and
    its cross ``kv``."""
    a, cache = attn.gqa_decode(lp["self"], cfg, _ln(lp["ln1"], h, cfg),
                               cache, pos, rules)
    return _cross_mlp(lp, cfg, h + a, kv, rules), cache


def decoder_train(params, cfg: ModelConfig, x: Tensor, enc_out: Tensor,
                  parallel=None, rules=None) -> Tensor:
    """x: (B, S, d) token embeddings (with positions); enc_out: (B,
    T_src, d).  Returns the hidden states (B, S, d)."""
    for lp in layer_list(params):
        x = remat(_policy(parallel), decoder_layer_train, lp, cfg, x, enc_out,
                  parallel, rules)
    return x


def _layer_kv(stacked: KV, i: int) -> KV:
    return {n: t[i] for n, t in stacked.items()}


def decoder_prefill(params, cfg: ModelConfig, x: Tensor, cross: KV,
                    parallel=None, rules=None) -> Tuple[Tensor, KV]:
    """Returns (hidden, the self caches stacked over layers)."""
    caches = []
    for i in range(cfg.num_layers):
        x, c = decoder_layer_prefill(layer_slice(params, i), cfg, x,
                                     _layer_kv(cross, i), parallel, rules)
        caches.append(c)
    return x, {n: torch.stack([c[n] for c in caches]) for n in ("k", "v")}


def decoder_decode(params, cfg: ModelConfig, x: Tensor, self_caches: KV,
                   cross: KV, pos: int, rules=None) -> Tuple[Tensor, KV]:
    """One-token decode, x (B, 1, d).  Each layer writes its slice of
    ``self_caches`` in place (``gqa_decode`` writes through the view);
    returns (hidden, ``self_caches``)."""
    for i in range(cfg.num_layers):
        x, _ = decoder_layer_decode(layer_slice(params, i), cfg, x,
                                    _layer_kv(self_caches, i),
                                    _layer_kv(cross, i), pos, rules)
    return x, self_caches
