"""Decoder-only stack assembly for the dense family.

The counterpart of the reference's ``models/transformer.py`` for
``family="dense"``: a Python loop over the stacked layers takes the
place of ``lax.scan``.  This slice is forward-only (the backbone serves
features), so ``remat`` has no meaning here.  The moe, hybrid, ssm and
vlm families raise ``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import make_norm, mlp_apply, mlp_schema
from repro_torch.models.params import layer_slice, stack_schema

Tensor = torch.Tensor

_LATER = {
    "moe": "the MoE slice (ROADMAP A.13: arctic, deepseek)",
    "hybrid": "the hybrid slice (ROADMAP A.13 / B.5: zamba2, ssd_pallas)",
    "ssm": "the rwkv6 slice (ROADMAP A.13 / B.4: gla_pallas)",
    "vlm": "the vlm slice (ROADMAP A.13: pixtral front end)",
    "audio": "the encoder-decoder slice (ROADMAP A.13: whisper)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_LATER.get(cfg.family, 'no slice planned')}")


class Blocks:
    """Per-layer block functions bound to (cfg, parallel)."""

    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig):
        self.cfg, self.parallel = cfg, parallel
        self.norm_schema, self.norm = make_norm(cfg)

    def dense_schema(self):
        """ln1, attention, ln2, MLP."""
        cfg = self.cfg
        return {"ln1": self.norm_schema(cfg.d_model),
                "attn": attn.attention_schema(cfg),
                "ln2": self.norm_schema(cfg.d_model),
                "mlp": mlp_schema(cfg)}

    def dense_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual block: (B, S, d) -> (B, S, d)."""
        x = x + attn.gqa_train(p["attn"], self.cfg, self.norm(p["ln1"], x),
                               self.parallel)
        return x + mlp_apply(p["mlp"], self.cfg, self.norm(p["ln2"], x))


class DecoderStack:
    """Hidden-state pipeline: embeddings in, hidden states out."""

    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig):
        _require_dense(cfg)
        self.cfg, self.parallel = cfg, parallel
        self.blocks = Blocks(cfg, parallel)

    def schema(self):
        """The stacked (num_layers, ...) layer weights."""
        return {"layers": stack_schema(self.blocks.dense_schema(),
                                       self.cfg.num_layers)}

    def train_hidden(self, params, x: Tensor) -> Tensor:
        """All layers in order over x (B, S, d).  The dense family has no
        auxiliary loss, so the reference's (x, aux) is just x here."""
        for i in range(self.cfg.num_layers):
            x = self.blocks.dense_train(layer_slice(params["layers"], i), x)
        return x
