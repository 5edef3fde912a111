"""Decoder-only stack assembly: dense, moe, ssm (rwkv6) and hybrid
(zamba2).

The counterpart of the reference's ``models/transformer.py`` for the
dense stack (GQA or MLA attention), the moe stack (arctic, deepseek-v3:
``first_k_dense`` dense layers, ``dense_ff`` wide, then MoE layers), the
rwkv6 stack and zamba2's groups of mamba layers each followed by one
weight-shared attention block.  A Python loop over the stacked layers
takes the place of ``lax.scan``; every pass (train, prefill, decode)
walks the blocks in the one order ``serve_layers`` gives.  Under
autograd ``train_hidden`` runs each block the reference scans under
``remat_policy`` (``remat``): "nothing" recomputes the whole block in
the backward (``torch.utils.checkpoint``), "dots" saves the matrix
products' outputs and recomputes the rest (selective checkpointing),
"full_save" saves everything; without grad the blocks just run.  Serving
caches are stacked on a leading layer axis as the reference's ``scan``
stacks them, so a cache converts leaf for leaf: dense {"k", "v"} (L, B,
S, KV, hd), or MLA's {"c_kv", "k_rope"} (L, B, S, ...); moe {"dense",
"moe"} of those (no "dense" without ``first_k_dense``); ssm {"tm": {"s",
"x_prev"}, "cm": {"x_prev"}} (L, ...); hybrid {"mamba": {"ssm", "conv"}
(L, ...), "attn": {"k", "v"} (groups, ...)}.  The vlm family (pixtral) is a
dense stack, as in the reference; the audio family (whisper) has no
decoder-only stack (``models/encdec.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import make_norm, mlp_apply, mlp_schema
from repro_torch.models.params import layer_list, stack_schema
from repro_torch.pytree import tree_map

Tensor = torch.Tensor

_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
REMAT_POLICIES = ("nothing", "dots", "full_save")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the matrix products' outputs, recompute
    everything else (the reference's ``dots_with_no_batch_dims_saveable``
    keeps its weight products; torch's einsums reach ``bmm`` too)."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn, *args):
    """``fn(*args)`` under the reference's remat ``policy`` when autograd
    records it (``jax.checkpoint`` around its scan body); without grad,
    or under "full_save", plainly."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if not torch.is_grad_enabled() or policy == "full_save":
        return fn(*args)
    if policy == "dots":
        return _ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _save_dots))
    return _ckpt.checkpoint(fn, *args, use_reentrant=False)


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

    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig,
                 rules=None):
        self.cfg, self.parallel, self.rules = cfg, parallel, rules
        self.norm_schema, self.norm = make_norm(cfg)

    def dense_schema(self, d_ff: Optional[int] = None,
                     use_moe: bool = False):
        """ln1, attention (GQA or MLA), ln2, then the MLP (``d_ff`` wide)
        or, with ``use_moe``, the MoE."""
        cfg = self.cfg
        sch = {"ln1": self.norm_schema(cfg.d_model),
               "attn": attn.attention_schema(cfg),
               "ln2": self.norm_schema(cfg.d_model)}
        if use_moe:
            sch["moe"] = moe_mod.moe_schema(cfg)
        else:
            sch["mlp"] = mlp_schema(cfg, d_ff)
        return sch

    def attn_train(self, p, x: Tensor) -> Tensor:
        """The attention weights ``p`` over normed x: GQA or MLA."""
        if self.cfg.attention == "mla":
            return attn.mla_train(p, self.cfg, x, self.parallel,
                                  rules=self.rules)
        return attn.gqa_train(p, self.cfg, x, self.parallel,
                              rules=self.rules)

    def attn_prefill(self, p, x: Tensor):
        """``attn_train`` plus the layer's cache ({"k", "v"} or MLA's
        {"c_kv", "k_rope"})."""
        if self.cfg.attention == "mla":
            return attn.mla_train(p, self.cfg, x, self.parallel,
                                  return_cache=True, rules=self.rules)
        return attn.gqa_prefill(p, self.cfg, x, self.parallel,
                                rules=self.rules)

    def attn_decode(self, p, x: Tensor, cache, pos: int):
        """One token against the layer's cache (written in place)."""
        if self.cfg.attention == "mla":
            return attn.mla_decode(p, self.cfg, x, cache, pos, self.rules)
        return attn.gqa_decode(p, self.cfg, x, cache, pos, self.rules)

    def ffn(self, p, x: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        """The block's second half over the residual x, un-added: (the
        MLP's or the MoE's output, the MoE's aux loss or None)."""
        h = self.norm(p["ln2"], x)
        if "moe" in p:
            return moe_mod.moe_apply(p["moe"], self.cfg, h, rules=self.rules)
        return mlp_apply(p["mlp"], self.cfg, h, self.rules), None

    def _ffn(self, p, x: Tensor, aux: Optional[list] = None) -> Tensor:
        y, a = self.ffn(p, x)
        if aux is not None and a is not None:
            aux.append(a)
        return x + y

    def dense_train(self, p, x: Tensor, aux: Optional[list] = None
                    ) -> Tensor:
        """Pre-norm residual block: (B, S, d) -> (B, S, d); a MoE
        block's aux loss is appended to ``aux`` where one is given."""
        x = constrain(x, ("batch", "seq", "embed_act"), self.rules)
        x = x + self.attn_train(p["attn"], self.norm(p["ln1"], x))
        return self._ffn(p, x, aux)

    def dense_prefill(self, p, x: Tensor):
        """``dense_train`` plus the layer's attention cache."""
        y, cache = self.attn_prefill(p["attn"], self.norm(p["ln1"], x))
        return self._ffn(p, x + y), cache

    def dense_decode(self, p, x: Tensor, cache, pos: int):
        """One token against the layer's cache (written in place)."""
        y, cache = self.attn_decode(p["attn"], self.norm(p["ln1"], x),
                                    cache, pos)
        return self._ffn(p, x + y), cache

    def mamba_schema(self):
        """ln, mamba."""
        return {"ln": self.norm_schema(self.cfg.d_model),
                "mamba": ssm_mod.mamba_schema(self.cfg)}

    def mamba_train(self, p, x: Tensor) -> Tensor:
        """Pre-norm residual mamba block."""
        x = constrain(x, ("batch", "seq", "embed_act"), self.rules)
        return x + ssm_mod.mamba_train(p["mamba"], self.cfg,
                                       self.norm(p["ln"], x), self.rules)

    def mamba_prefill(self, p, x: Tensor):
        """``mamba_train`` plus the layer's {"ssm", "conv"} state."""
        y, state = ssm_mod.mamba_prefill(p["mamba"], self.cfg,
                                         self.norm(p["ln"], x), self.rules)
        return x + y, state

    def mamba_decode(self, p, x: Tensor, state, pos: int = 0):
        """One token against the layer's state."""
        y, state = ssm_mod.mamba_decode(p["mamba"], self.cfg,
                                        self.norm(p["ln"], x), state,
                                        self.rules)
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
        x = constrain(x, ("batch", "seq", "embed_act"), self.rules)
        x = x + rwkv_mod.time_mix_train(p["tm"], cfg, self.norm(p["ln1"], x),
                                        chunk=cfg.ssm_chunk, rules=self.rules)
        return x + rwkv_mod.channel_mix_train(p["cm"], cfg,
                                              self.norm(p["ln2"], x),
                                              rules=self.rules)

    def rwkv_prefill(self, p, x: Tensor):
        """``rwkv_train`` plus the layer's {"tm", "cm"} state."""
        cfg = self.cfg
        y, tm = rwkv_mod.time_mix_prefill(p["tm"], cfg,
                                          self.norm(p["ln1"], x),
                                          chunk=cfg.ssm_chunk,
                                          rules=self.rules)
        x = x + y
        y, cm = rwkv_mod.channel_mix_prefill(p["cm"], cfg,
                                             self.norm(p["ln2"], x),
                                             rules=self.rules)
        return x + y, {"tm": tm, "cm": cm}

    def rwkv_decode(self, p, x: Tensor, state, pos: int = 0):
        """One token against the layer's state."""
        cfg = self.cfg
        y, tm = rwkv_mod.time_mix_decode(p["tm"], cfg, self.norm(p["ln1"], x),
                                         state["tm"], rules=self.rules)
        x = x + y
        y, cm = rwkv_mod.channel_mix_decode(p["cm"], cfg,
                                            self.norm(p["ln2"], x),
                                            state["cm"], rules=self.rules)
        return x + y, {"tm": tm, "cm": cm}


class DecoderStack:
    """Hidden-state pipeline: embeddings in, hidden states out."""

    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig,
                 rules=None):
        if cfg.family not in _FAMILIES:
            raise ValueError(f"family {cfg.family!r} has no decoder-only "
                             f"stack (one of {_FAMILIES}); an encoder-"
                             f"decoder runs through models/encdec.py")
        self.cfg, self.parallel, self.rules = cfg, parallel, rules
        self.blocks = Blocks(cfg, parallel, rules)

    def schema(self):
        """The stacked (num_layers, ...) layer weights; hybrid adds the
        one shared attention block; moe stacks ``dense_layers`` (the
        first ``first_k_dense``) and ``moe_layers``."""
        cfg, b = self.cfg, self.blocks
        if cfg.family == "hybrid":
            return {"mamba_layers": stack_schema(b.mamba_schema(),
                                                 cfg.num_layers),
                    "shared_attn": b.dense_schema()}
        if cfg.family == "moe":
            sch = {}
            if cfg.first_k_dense:
                sch["dense_layers"] = stack_schema(
                    b.dense_schema(d_ff=cfg.dense_ff or cfg.d_ff),
                    cfg.first_k_dense)
            sch["moe_layers"] = stack_schema(b.dense_schema(use_moe=True),
                                             cfg.num_layers
                                             - cfg.first_k_dense)
            return sch
        layer = b.rwkv_schema() if cfg.family == "ssm" else b.dense_schema()
        return {"layers": stack_schema(layer, cfg.num_layers)}

    def _groups(self):
        """Mamba layers per group, each group followed by the shared
        attention block (zamba2: 6,6,6,6,6,6,2)."""
        cfg = self.cfg
        g = cfg.shared_attn_every or cfg.num_layers
        return [min(g, cfg.num_layers - s) for s in range(0, cfg.num_layers, g)]

    def serve_layers(self, params
                     ) -> Iterator[Tuple[str, str, Tuple[Optional[str], int],
                                         Any]]:
        """(name, kind, (cache part, index), weights) of every block, in
        the order the forward applies them; kind is "dense", "mamba" or
        "rwkv", and the block's cache is ``cache[part][index]`` (the
        whole cache's ``[index]`` where part is None).  Hybrid puts the
        shared attention block after each group, at the group's index of
        "attn"; moe walks "dense" then "moe"."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            start, mamba = 0, layer_list(params["mamba_layers"])
            for g, size in enumerate(self._groups()):
                for i in range(start, start + size):
                    yield (f"mamba {i}", "mamba", ("mamba", i), mamba[i])
                yield ("shared attn", "dense", ("attn", g),
                       params["shared_attn"])
                start += size
            return
        if cfg.family == "moe":
            if cfg.first_k_dense:
                for i, p in enumerate(layer_list(params["dense_layers"])):
                    yield (f"dense {i}", "dense", ("dense", i), p)
            for i, p in enumerate(layer_list(params["moe_layers"])):
                yield (f"moe {i}", "dense", ("moe", i), p)
            return
        kind = "rwkv" if cfg.family == "ssm" else "dense"
        for i, p in enumerate(layer_list(params["layers"])):
            yield (f"layer {i}", kind, (None, i), p)

    def layers(self, params):
        """(name, train block fn, its weights) of every block, in order."""
        for name, kind, _, p in self.serve_layers(params):
            yield name, getattr(self.blocks, kind + "_train"), p

    @staticmethod
    def cache_part(cache, part: Optional[str]):
        """The stacked cache a block of ``part`` indexes into."""
        return cache if part is None else cache[part]

    def _block_train(self, kind: str, p, x: Tensor):
        """One block's train form: (x, its MoE aux loss or None)."""
        if kind != "dense":
            return getattr(self.blocks, kind + "_train")(p, x), None
        aux: List[Tensor] = []
        x = self.blocks.dense_train(p, x, aux)
        return x, (aux[0] if aux else None)

    def train_hidden(self, params, x: Tensor, with_aux: bool = False):
        """All blocks in order over x (B, S, d), each the reference scans
        under ``remat`` with ``parallel.remat_policy`` (zamba2's shared
        block, applied outside its scan, plainly).  With ``with_aux``, (x,
        the MoE layers' aux losses summed from an fp32 0) as the
        reference's ``train_hidden`` returns; else x alone."""
        policy = self.parallel.remat_policy
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for name, kind, _, p in self.serve_layers(params):
            if name == "shared attn":
                x, a = self._block_train(kind, p, x)
            else:
                x, a = remat(policy, self._block_train, kind, p, x)
            if a is not None:
                total = total + a
        return (x, total) if with_aux else x

    def prefill_hidden(self, params, x: Tensor):
        """All blocks in prefill form over the prompt x (B, S, d):
        (hidden states, the cache stacked per layer)."""
        per: Dict[Optional[str], List[Any]] = {}
        for _, kind, (part, _), p in self.serve_layers(params):
            x, c = getattr(self.blocks, kind + "_prefill")(p, x)
            per.setdefault(part, []).append(c)
        stacked = {part: tree_map(lambda *a: torch.stack(a), *cs)
                   for part, cs in per.items()}
        return x, stacked.get(None, stacked)

    def decode_hidden(self, params, x: Tensor, cache, pos: int):
        """All blocks in decode form for one token x (B, 1, d) at
        ``pos``.  Writes ``cache`` in place and returns it."""
        for _, kind, (part, i), p in self.serve_layers(params):
            stack = self.cache_part(cache, part)
            x, new = getattr(self.blocks, kind + "_decode")(
                p, x, tree_map(lambda a: a[i], stack), pos)
            _write(stack, i, new)
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
        if cfg.family == "moe":
            caches = {}
            if cfg.first_k_dense:
                caches["dense"] = attn.init_cache(
                    cfg, batch, seq_len, cfg.first_k_dense, dt, device)
            caches["moe"] = attn.init_cache(
                cfg, batch, seq_len, cfg.num_layers - cfg.first_k_dense, dt,
                device)
            return caches
        return attn.init_cache(cfg, batch, seq_len, cfg.num_layers, dt, device)
