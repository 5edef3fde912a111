"""Decoder-only stack assembly: dense, ssm (rwkv6) and hybrid (zamba2).

The counterpart of the reference's ``models/transformer.py`` for the
dense GQA stack, the rwkv6 stack and zamba2's groups of mamba layers
each followed by one weight-shared attention block.  A Python loop over
the stacked layers takes the place of ``lax.scan``; every pass (train,
prefill, decode) walks the blocks in the one order ``serve_layers``
gives.  The train forward has no backward here, so ``remat`` has no
meaning.  Serving caches are stacked on a leading layer axis as the
reference's ``scan`` stacks them, so a cache converts leaf for leaf:
dense {"k", "v"} (L, B, S, KV, hd); ssm {"tm": {"s", "x_prev"}, "cm":
{"x_prev"}} (L, ...); hybrid {"mamba": {"ssm", "conv"} (L, ...),
"attn": {"k", "v"} (groups, ...)}.  The moe (ROADMAP A.13b), vlm and
audio (A.13e) families raise ``NotImplementedError`` naming their item.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.inference.executor import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import make_norm, mlp_apply, mlp_schema
from repro_torch.models.params import layer_slice, stack_schema

Tensor = torch.Tensor

_LATER = {
    "moe": "the MoE slice (ROADMAP A.13b: arctic, deepseek)",
    "vlm": "the vlm slice (ROADMAP A.13e: pixtral front end)",
    "audio": "the encoder-decoder slice (ROADMAP A.13e: whisper)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_LATER.get(cfg.family, 'no slice planned')}")


def _write(dst, i: int, src) -> None:
    """dst[i] = src leaf by leaf, in place; a leaf that already is that
    slice (a KV cache written in place) is left alone."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], i, src[k])
        return
    slot = dst[i]
    if src.data_ptr() != slot.data_ptr() or src.shape != slot.shape:
        slot.copy_(src)


class Blocks:
    """Per-layer block functions bound to (cfg, parallel).  Every
    ``*_decode`` takes (p, x, cache, pos); the recurrent blocks ignore
    ``pos``."""

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

    def _mlp(self, p, x: Tensor) -> Tensor:
        return x + mlp_apply(p["mlp"], self.cfg, self.norm(p["ln2"], x))

    def dense_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual block: (B, S, d) -> (B, S, d)."""
        x = x + attn.gqa_train(p["attn"], self.cfg, self.norm(p["ln1"], x),
                               self.parallel)
        return self._mlp(p, x)

    def dense_prefill(self, p, x: Tensor):
        """``dense_train`` plus the layer's {"k", "v"}."""
        y, cache = attn.gqa_prefill(p["attn"], self.cfg,
                                    self.norm(p["ln1"], x), self.parallel)
        return self._mlp(p, x + y), cache

    def dense_decode(self, p, x: Tensor, cache, pos: int):
        """One token against the layer's KV cache (written in place)."""
        y, cache = attn.gqa_decode(p["attn"], self.cfg,
                                   self.norm(p["ln1"], x), cache, pos)
        return self._mlp(p, x + y), cache

    def mamba_schema(self):
        """ln, mamba."""
        return {"ln": self.norm_schema(self.cfg.d_model),
                "mamba": ssm_mod.mamba_schema(self.cfg)}

    def mamba_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual mamba block."""
        return x + ssm_mod.mamba_train(p["mamba"], self.cfg,
                                       self.norm(p["ln"], x))

    def mamba_prefill(self, p, x: Tensor):
        """``mamba_train`` plus the layer's {"ssm", "conv"} state."""
        y, state = ssm_mod.mamba_prefill(p["mamba"], self.cfg,
                                         self.norm(p["ln"], x))
        return x + y, state

    def mamba_decode(self, p, x: Tensor, state, pos: int = 0):
        """One token against the layer's state."""
        y, state = ssm_mod.mamba_decode(p["mamba"], self.cfg,
                                        self.norm(p["ln"], x), state)
        return x + y, state

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

    def rwkv_prefill(self, p, x: Tensor):
        """``rwkv_train`` plus the layer's {"tm", "cm"} state."""
        cfg = self.cfg
        y, tm = rwkv_mod.time_mix_prefill(p["tm"], cfg,
                                          self.norm(p["ln1"], x),
                                          chunk=cfg.ssm_chunk)
        x = x + y
        y, cm = rwkv_mod.channel_mix_prefill(p["cm"], cfg,
                                             self.norm(p["ln2"], x))
        return x + y, {"tm": tm, "cm": cm}

    def rwkv_decode(self, p, x: Tensor, state, pos: int = 0):
        """One token against the layer's state."""
        cfg = self.cfg
        y, tm = rwkv_mod.time_mix_decode(p["tm"], cfg, self.norm(p["ln1"], x),
                                         state["tm"])
        x = x + y
        y, cm = rwkv_mod.channel_mix_decode(p["cm"], cfg,
                                            self.norm(p["ln2"], x),
                                            state["cm"])
        return x + y, {"tm": tm, "cm": cm}


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

    def serve_layers(self, params) -> Iterator[Tuple[str, str, int, Any]]:
        """(name, kind, cache index, weights) of every block, in the order
        the forward applies them; kind is "dense", "mamba" or "rwkv".
        Hybrid puts the shared attention block after each group; its
        cache index is the group's."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            start = 0
            for g, size in enumerate(self._groups()):
                for i in range(start, start + size):
                    yield (f"mamba {i}", "mamba", i,
                           layer_slice(params["mamba_layers"], i))
                yield "shared attn", "dense", g, params["shared_attn"]
                start += size
            return
        kind = "rwkv" if cfg.family == "ssm" else "dense"
        for i in range(cfg.num_layers):
            yield f"layer {i}", kind, i, layer_slice(params["layers"], i)

    def layers(self, params):
        """(name, train block fn, its weights) of every block, in order."""
        for name, kind, _, p in self.serve_layers(params):
            yield name, getattr(self.blocks, kind + "_train"), p

    def cache_part(self, cache, kind: str):
        """The stacked cache that blocks of ``kind`` index into."""
        if self.cfg.family == "hybrid":
            return cache["attn"] if kind == "dense" else cache["mamba"]
        return cache

    def train_hidden(self, params, x: Tensor) -> Tensor:
        """All blocks in order over x (B, S, d).  These families have no
        auxiliary loss, so the reference's (x, aux) is just x here."""
        for _, block, p in self.layers(params):
            x = block(p, x)
        return x

    def prefill_hidden(self, params, x: Tensor):
        """All blocks in prefill form over the prompt x (B, S, d):
        (hidden states, the cache stacked per layer)."""
        per: Dict[str, List[Any]] = {}
        for _, kind, _, p in self.serve_layers(params):
            x, c = getattr(self.blocks, kind + "_prefill")(p, x)
            per.setdefault(kind, []).append(c)
        stacked = {kind: tree_map(lambda *a: torch.stack(a), *cs)
                   for kind, cs in per.items()}
        if self.cfg.family == "hybrid":
            return x, {"mamba": stacked["mamba"], "attn": stacked["dense"]}
        return x, next(iter(stacked.values()))

    def decode_hidden(self, params, x: Tensor, cache, pos: int):
        """All blocks in decode form for one token x (B, 1, d) at
        ``pos``.  Writes ``cache`` in place and returns it."""
        for _, kind, i, p in self.serve_layers(params):
            part = self.cache_part(cache, kind)
            x, new = getattr(self.blocks, kind + "_decode")(
                p, x, tree_map(lambda a: a[i], part), pos)
            _write(part, i, new)
        return x, cache

    def init_cache(self, batch: int, seq_len: int, device=None):
        """Zeros of the decode cache for ``batch`` rows of ``seq_len``
        positions; attention caches and the conv / shift inputs in the
        compute dtype, the scans' states in fp32."""
        cfg = self.cfg
        dt = cfg.compute_dtype

        def per_layer(tree, n):
            return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)

        if cfg.family == "hybrid":
            return {"mamba": per_layer(ssm_mod.mamba_init_state(
                        cfg, batch, dt, device), cfg.num_layers),
                    "attn": attn.init_cache(cfg, batch, seq_len,
                                            len(self._groups()), dt, device)}
        if cfg.family == "ssm":
            return per_layer(rwkv_mod.rwkv_init_state(cfg, batch, dt, device),
                             cfg.num_layers)
        return attn.init_cache(cfg, batch, seq_len, cfg.num_layers, dt, device)
