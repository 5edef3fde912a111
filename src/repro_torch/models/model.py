"""Model facade: an ``nn.Module`` that owns its parameters.

The counterpart of the reference's ``models/model.py`` for all ten
architectures: the dense (granite, yi, phi4-mini, chatglm3), vlm
(pixtral: a dense stack whose first positions take precomputed patch
embeddings), moe (arctic, deepseek-v3: MLA and MoE), ssm (rwkv6) and
hybrid (zamba2) families through ``transformer.DecoderStack``, and the
encoder-decoder (whisper: ``models/encdec.py``).  ``features(tokens)``
— the pooled event-sequence representation that the Dream11 scenario
uses as confounders (paper §4) — and the serving forms ``prefill``,
``decode_step`` (alias ``serve_step``) and ``init_cache``, which
``launch/serve.py``'s ``BatchServer`` drives.  ``features`` and
``prefill`` take the reference's batch extras as keywords: ``frames``
(B, T_src, d_model), which an encoder-decoder needs, and
``patch_embeds`` (B, P, d_model), which a vlm may take; a model refuses
an extra it does not read.  Parameters are registered under the
reference's schema names (``embed.embedding``, ``stack.layers.attn.wq``,
``decoder.self.wq``, ``encoder.layers.attn.wq``, ``ln_f.scale``), so
``state_dict()`` keys are the reference's pytree paths and
``convert.model_params`` loads the reference's weights unchanged;
``convert.cache`` carries a reference cache across the same way.

``Model(cfg, parallel, rules=None, device=None, seed=0)`` initialises
on a ``torch.Generator`` seeded ``seed`` on ``device`` (the card unless
``device="cpu"``), with the reference's init rule
(``models/params.py``).  ``rules`` (``distributed.sharding.
ShardingRules``) reach the reference's ``constrain`` sites in every
family's code; they act only on DTensors inside a ``mesh_context`` (the
dry run), and the shape methods ``param_specs`` / ``param_shardings`` /
``abstract_params`` / ``input_specs`` / ``supports_shape`` serve
``launch/cells.py``.  Off the CPU a family with self-attention
(every one but ssm) needs ``ParallelConfig(use_flash_attention=True)``
(the flash kernel) or ``attention_impl="chunked"`` (the reference's XLA
attention, plain torch); rwkv6 has none and needs no flag.

Training: ``forward_train`` (logits in the compute dtype and the aux
loss: the MoE layers' and, with ``mtp_depth``, deepseek-v3's
multi-token-prediction loss ``_mtp_loss``, weighted ``MTP_WEIGHT``) and
``loss_fn`` (CE + aux).  Both take ``params=``: a nested dict of the
model's trees ({"embed": ..., "stack": ..., "ln_f": ...}, the
state_dict's paths) that replaces the module's own weights, which is
how ``launch/train.py`` runs on weights cast to the compute dtype with
the gradients flowing back to fp32 masters.  Without it the module's
own (frozen) parameters are read.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.layers import (embed_tokens, embedding_schema,
                                      make_norm, softmax_cross_entropy,
                                      unembed)
from repro_torch.models.params import (ParamDef, ParamTree, init_params,
                                       stack_schema)
from repro_torch.models.transformer import Blocks, DecoderStack

Tensor = torch.Tensor
Params = Optional[Dict[str, Any]]

MTP_WEIGHT = 0.3  # deepseek-v3's MTP loss weight (the paper's lambda)


class Model(nn.Module):
    """A frozen LM backbone of any of the registry's families."""

    def __init__(self, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None, rules=None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.rules = rules
        # the block functions; the weights are the modules added below
        # (``self.decoder`` is an encoder-decoder's decoder weights)
        self.decoder_stack = (None if cfg.is_encdec
                              else DecoderStack(cfg, self.parallel, rules))
        _, self.norm = make_norm(cfg)
        dev = resolve_device(device)
        if (dev.type != "cpu" and cfg.family != "ssm"
                and not self.parallel.use_flash_attention
                and self.parallel.attention_impl != "chunked"):
            raise NotImplementedError(
                f"on {dev} attention runs through the flash kernel or the "
                f"chunked attention only: pass ParallelConfig("
                f"use_flash_attention=True) or attention_impl='chunked'")
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, tree in init_params(gen, self.schema(),
                                      cfg.param_dtype).items():
            self.add_module(name, ParamTree(tree))

    @staticmethod
    def schema_of(cfg: ModelConfig,
                  parallel: Optional[ParallelConfig] = None
                  ) -> Dict[str, Any]:
        """The reference's parameter schema (``Model.schema``) of a model
        of ``cfg``, without building one."""
        parallel = parallel or ParallelConfig()
        norm_schema, _ = make_norm(cfg)
        sch: Dict[str, Any] = {"embed": embedding_schema(cfg)}
        if cfg.is_encdec:
            sch["encoder"] = encdec.encoder_schema(cfg)
            sch["decoder"] = stack_schema(encdec.decoder_layer_schema(cfg),
                                          cfg.num_layers)
        else:
            sch["stack"] = DecoderStack(cfg, parallel).schema()
            if cfg.mtp_depth:
                d = cfg.d_model
                sch["mtp"] = {
                    "proj": ParamDef((2 * d, d), ("embed", None),
                                     init="scaled"),
                    "ln_h": norm_schema(d), "ln_e": norm_schema(d),
                    "block": Blocks(cfg, parallel).dense_schema(
                        d_ff=cfg.dense_ff or cfg.d_ff)}
        sch["ln_f"] = norm_schema(cfg.d_model)
        return sch

    def schema(self) -> Dict[str, Any]:
        """This model's parameter schema (``schema_of``)."""
        return self.schema_of(self.cfg, self.parallel)

    def abstract_params(self) -> Dict[str, Any]:
        """The schema's tensors on the meta device (no allocation)."""
        return sharding.abstract_params(self.schema(), self.cfg.param_dtype)

    def param_specs(self, rules, mesh=None):
        """PartitionSpecs of every parameter under ``rules``."""
        return sharding.param_specs(self.schema(), rules, mesh)

    def param_shardings(self, rules, mesh):
        """NamedShardings of every parameter on ``mesh``."""
        return sharding.param_shardings(self.schema(), rules, mesh)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The entry point's inputs at ``shape`` as {name: (shape,
        dtype)}: train {"tokens", "labels"} and prefill {"tokens"} (B, S)
        int32, plus a vlm's ``patch_embeds`` and an encoder-decoder's
        ``frames``; decode {"tokens" (B, 1), "cache": ``init_cache(B,
        S)`` on the meta device, "pos" ()}."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        tok = lambda *sh: (tuple(sh), i32)                  # noqa: E731
        act = lambda *sh: (tuple(sh), cfg.compute_dtype)    # noqa: E731

        def extras() -> Dict[str, Any]:
            ex: Dict[str, Any] = {}
            if cfg.family == "vlm":
                ex["patch_embeds"] = act(B, _num_patches(S), cfg.d_model)
            if cfg.is_encdec:
                ex["frames"] = act(B, cfg.max_source_positions, cfg.d_model)
            return ex

        if shape.kind == "train":
            return {"tokens": tok(B, S), "labels": tok(B, S), **extras()}
        if shape.kind == "prefill":
            return {"tokens": tok(B, S), **extras()}
        if shape.kind == "decode":
            return {"tokens": tok(B, 1),
                    "cache": self.init_cache(B, S, device="meta"),
                    "pos": tok()}
        raise ValueError(shape.kind)

    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """Shape-cell applicability (the reference's rule)."""
        cfg = self.cfg
        if shape.name == "long_500k" and not cfg.is_subquadratic:
            return False, ("full quadratic attention: long_500k requires "
                           "sub-quadratic sequence mixing (skip per spec)")
        return True, ""

    @property
    def device(self) -> torch.device:
        """Where the parameters live."""
        return self.embed["embedding"].device

    def _tree(self, params: Params, name: str):
        """The weights ``name`` ("embed", "stack", ...): ``params``'s if
        given, else the module's own."""
        return getattr(self, name) if params is None else params[name]

    def _encode(self, frames: Tensor, params: Params = None) -> Tensor:
        """An encoder-decoder's encoder output (B, T_src, d)."""
        return encdec.encode(self._tree(params, "encoder"), self.cfg,
                             torch.as_tensor(frames, device=self.device),
                             self.parallel, self.rules)

    def _embed_in(self, tokens: Tensor, frames: Optional[Tensor] = None,
                  patch_embeds: Optional[Tensor] = None,
                  params: Params = None) -> Tensor:
        """The tokens' embeddings (B, S, d) in the compute dtype; a vlm's
        ``patch_embeds`` (B, P, d) take the first P positions.  Refuses
        an extra the model does not read, and an encoder-decoder without
        its ``frames``."""
        cfg = self.cfg
        if cfg.is_encdec != (frames is not None):
            raise ValueError(
                f"{cfg.name}: frames (B, T_src, d_model) are "
                + ("needed" if cfg.is_encdec else
                   "an encoder-decoder's input, not this model's"))
        if patch_embeds is not None and cfg.family != "vlm":
            raise ValueError(f"{cfg.name}: patch_embeds are a vlm's input, "
                             f"not this {cfg.family} model's")
        x = embed_tokens(self._tree(params, "embed"), cfg,
                         torch.as_tensor(tokens, device=self.device),
                         rules=self.rules)
        if patch_embeds is not None:
            pe = torch.as_tensor(patch_embeds, device=self.device).to(
                cfg.compute_dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
            x = constrain(x, ("batch", "seq", "embed_act"), self.rules)
        return x

    def _hidden(self, tokens: Tensor, frames: Optional[Tensor] = None,
                patch_embeds: Optional[Tensor] = None) -> Tensor:
        """The train forward's hidden states (B, S, d), before ln_f."""
        return self._hidden_aux(tokens, frames, patch_embeds)[0]

    def _hidden_aux(self, tokens: Tensor, frames: Optional[Tensor] = None,
                    patch_embeds: Optional[Tensor] = None,
                    params: Params = None) -> Tuple[Tensor, Tensor]:
        """``_hidden`` at ``params`` and the MoE layers' aux loss (an fp32
        0 for the other families)."""
        x = self._embed_in(tokens, frames, patch_embeds, params)
        if self.cfg.is_encdec:
            h = encdec.decoder_train(self._tree(params, "decoder"), self.cfg,
                                     x, self._encode(frames, params),
                                     self.parallel, self.rules)
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        return self.decoder_stack.train_hidden(self._tree(params, "stack"),
                                               x, with_aux=True)

    def forward_train(self, tokens: Tensor, labels: Optional[Tensor] = None,
                      *, frames: Optional[Tensor] = None,
                      patch_embeds: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None,
                      params: Params = None) -> Tuple[Tensor, Tensor]:
        """(logits (B, S, padded_vocab) in the compute dtype, the aux loss
        (fp32 scalar)): the reference's ``Model.forward_train``.  The aux
        is the MoE layers' load-balance losses plus, with ``mtp_depth``,
        the multi-token-prediction loss, which reads ``labels``; ``mask``
        is the loss's (``loss_fn``), taken here for the batch's sake."""
        h, aux = self._hidden_aux(tokens, frames, patch_embeds, params)
        logits = self._logits(h, params)
        if self.cfg.mtp_depth:
            aux = aux + self._mtp_loss(tokens, labels, h, params)
        return logits, aux

    def _mtp_loss(self, tokens: Tensor, labels: Tensor, h: Tensor,
                  params: Params = None) -> Tensor:
        """DeepSeek-V3's multi-token prediction at depth 1: token t+2
        from [norm(h_t); norm(emb(token t+1))] through ``proj`` and one
        dense block, CE over the shared unembedding, times MTP_WEIGHT."""
        cfg, p = self.cfg, self._tree(params, "mtp")
        tokens = torch.as_tensor(tokens, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        e_next = embed_tokens(self._tree(params, "embed"), cfg, tokens[:, 1:],
                              rules=self.rules)
        z = torch.cat([self.norm(p["ln_h"], h[:, :-1]),
                       self.norm(p["ln_e"], e_next)], dim=-1)
        z = sharding.matmul(z, p["proj"].to(cfg.compute_dtype))
        z = self.decoder_stack.blocks.dense_train(p["block"], z)
        logits = self._logits(z, params)                 # (B, S-1, V)
        return MTP_WEIGHT * softmax_cross_entropy(logits[:, :-1],
                                                  labels[:, 2:])

    def loss_fn(self, tokens: Tensor, labels: Tensor, *,
                frames: Optional[Tensor] = None,
                patch_embeds: Optional[Tensor] = None,
                mask: Optional[Tensor] = None, params: Params = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """(CE + aux, {"ce", "aux"}): the reference's ``Model.loss_fn``
        over one batch; the CE is masked by ``mask`` (B, S) if given."""
        logits, aux = self.forward_train(tokens, labels, frames=frames,
                                         patch_embeds=patch_embeds,
                                         params=params)
        labels = torch.as_tensor(labels, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        ce = softmax_cross_entropy(logits, labels, mask)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def features(self, tokens: Tensor, *, frames: Optional[Tensor] = None,
                 patch_embeds: Optional[Tensor] = None) -> Tensor:
        """(n, S) event tokens (and the model's extras) -> (n, d_model)
        fp32: the final-norm hidden states mean-pooled over the sequence
        (pooled in the compute dtype, as the reference pools them)."""
        h = self.norm(self.ln_f, self._hidden(tokens, frames, patch_embeds))
        return h.mean(dim=1).to(torch.float32)

    def _logits(self, h: Tensor, params: Params = None) -> Tensor:
        """Final norm and unembedding: (..., d) -> (..., padded_vocab)
        logits in the compute dtype."""
        return unembed(self._tree(params, "embed"), self.cfg,
                       self.norm(self._tree(params, "ln_f"), h), self.rules)

    @torch.no_grad()
    def prefill(self, tokens: Tensor, *, frames: Optional[Tensor] = None,
                patch_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Any]:
        """Full forward over the prompt (B, S) (and the model's extras):
        (last-token logits (B, 1, V), the cache of S positions; an
        encoder-decoder's is {"self": S positions, "cross": the frames'
        T_src})."""
        x = self._embed_in(tokens, frames, patch_embeds)
        if self.cfg.is_encdec:
            cross = encdec.encoder_cross_kv(self.decoder, self.cfg,
                                            self._encode(frames))
            h, self_caches = encdec.decoder_prefill(
                self.decoder, self.cfg, x, cross, self.parallel, self.rules)
            cache = {"self": self_caches, "cross": cross}
        else:
            h, cache = self.decoder_stack.prefill_hidden(self.stack, x)
        return self._logits(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, cache: Any, pos: int
                    ) -> Tuple[Tensor, Any]:
        """One new token per row.  tokens: (B, 1); ``pos`` the index the
        new token is written at (the cache holds positions < pos), and
        its learned position (clamped into the table, as the reference's
        ``dynamic_slice``).  Returns (logits (B, 1, V), cache).  The
        cache is written IN PLACE and the same tree returned (the
        reference donates it to the jitted step), so a caller that needs
        the old cache keeps a copy."""
        cfg, pos = self.cfg, int(pos)
        tokens = torch.as_tensor(tokens, device=self.device)
        at = min(max(pos, 0), cfg.max_position_embeddings - 1)
        x = embed_tokens(self.embed, cfg, tokens, pos_offset=at)
        x = constrain(x, ("batch", "seq", "embed_act"), self.rules)
        if cfg.is_encdec:
            h, _ = encdec.decoder_decode(self.decoder, cfg, x, cache["self"],
                                         cache["cross"], pos, self.rules)
        else:
            h, cache = self.decoder_stack.decode_hidden(self.stack, x, cache,
                                                        pos)
        return self._logits(h), cache

    serve_step = decode_step

    def init_cache(self, batch: int, seq_len: int, device=None) -> Any:
        """A zero cache for ``batch`` rows of ``seq_len`` positions, on
        ``device`` (the model's by default); an encoder-decoder's cross
        half holds ``max_source_positions``."""
        cfg = self.cfg
        dev = self.device if device is None else device
        if not cfg.is_encdec:
            return self.decoder_stack.init_cache(batch, seq_len, device=dev)
        return {"self": attn.init_cache(cfg, batch, seq_len, cfg.num_layers,
                                        device=dev),
                "cross": attn.init_cache(cfg, batch, cfg.max_source_positions,
                                         cfg.num_layers, device=dev)}


def _num_patches(seq_len: int) -> int:
    """vlm stub: patch positions spliced at the front of the sequence."""
    return max(1, min(256, seq_len // 4))


def build_model(cfg: ModelConfig, parallel: Optional[ParallelConfig] = None,
                rules=None, *, device: DeviceLike = None,
                seed: int = 0) -> Model:
    """``Model(cfg, parallel, rules, device=, seed=)``."""
    return Model(cfg, parallel, rules, device=device, seed=seed)
