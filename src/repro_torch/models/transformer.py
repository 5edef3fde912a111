"""Decoder-only stack assembly: dense, ssm (rwkv6) and hybrid (zamba2).

The counterpart of the reference's ``models/transformer.py`` for the
dense GQA stack, the rwkv6 stack and zamba2's groups of mamba layers
each followed by one weight-shared attention block.  A Python loop over
the stacked layers takes the place of ``lax.scan``.  The port runs the
forward path only (the backbone serves features), so ``remat`` has no
meaning here.  The moe, vlm and audio families raise
``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import make_norm, mlp_apply, mlp_schema
from repro_torch.models.params import layer_slice, stack_schema

Tensor = torch.Tensor

_LATER = {
    "moe": "the MoE slice (ROADMAP A.13: arctic, deepseek)",
    "vlm": "the vlm slice (ROADMAP A.13: pixtral front end)",
    "audio": "the encoder-decoder slice (ROADMAP A.13: whisper)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm", "hybrid"):
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

    def mamba_schema(self):
        """ln, mamba."""
        return {"ln": self.norm_schema(self.cfg.d_model),
                "mamba": ssm_mod.mamba_schema(self.cfg)}

    def mamba_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual mamba block."""
        return x + ssm_mod.mamba_train(p["mamba"], self.cfg,
                                       self.norm(p["ln"], x))

    def rwkv_schema(self):
        """ln1, time-mix, ln2, channel-mix."""
        d = self.cfg.d_model
        return {"ln1": self.norm_schema(d),
                "tm": rwkv_mod.time_mix_schema(self.cfg),
                "ln2": self.norm_schema(d),
                "cm": rwkv_mod.channel_mix_schema(self.cfg)}

    def rwkv_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual time-mix, then channel-mix."""
        cfg = self.cfg
        x = x + rwkv_mod.time_mix_train(p["tm"], cfg, self.norm(p["ln1"], x),
                                        chunk=cfg.ssm_chunk)
        return x + rwkv_mod.channel_mix_train(p["cm"], cfg,
                                              self.norm(p["ln2"], x))


class DecoderStack:
    """Hidden-state pipeline: embeddings in, hidden states out."""

    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig):
        _require_ported(cfg)
        self.cfg, self.parallel = cfg, parallel
        self.blocks = Blocks(cfg, parallel)

    def schema(self):
        """The stacked (num_layers, ...) layer weights; hybrid adds the
        one shared attention block."""
        cfg, b = self.cfg, self.blocks
        if cfg.family == "hybrid":
            return {"mamba_layers": stack_schema(b.mamba_schema(),
                                                 cfg.num_layers),
                    "shared_attn": b.dense_schema()}
        layer = b.rwkv_schema() if cfg.family == "ssm" else b.dense_schema()
        return {"layers": stack_schema(layer, cfg.num_layers)}

    def _groups(self):
        """Mamba layers per group, each group followed by the shared
        attention block (zamba2: 6,6,6,6,6,6,2)."""
        cfg = self.cfg
        g = cfg.shared_attn_every or cfg.num_layers
        return [min(g, cfg.num_layers - s) for s in range(0, cfg.num_layers, g)]

    def layers(self, params):
        """(name, block fn, its weights) of every block, in the order the
        forward applies them; hybrid puts the shared attention block
        after each group."""
        cfg, b = self.cfg, self.blocks
        if cfg.family == "hybrid":
            start = 0
            for size in self._groups():
                for i in range(start, start + size):
                    yield (f"mamba {i}", b.mamba_train,
                           layer_slice(params["mamba_layers"], i))
                yield "shared attn", b.dense_train, params["shared_attn"]
                start += size
            return
        block = b.rwkv_train if cfg.family == "ssm" else b.dense_train
        for i in range(cfg.num_layers):
            yield f"layer {i}", block, layer_slice(params["layers"], i)

    def train_hidden(self, params, x: Tensor) -> Tensor:
        """All blocks in order over x (B, S, d).  These families have no
        auxiliary loss, so the reference's (x, aux) is just x here."""
        for _, block, p in self.layers(params):
            x = block(p, x)
        return x
