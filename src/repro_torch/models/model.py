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

``Model(cfg, parallel, device=None, seed=0)`` initialises on a
``torch.Generator`` seeded ``seed`` on ``device`` (the card unless
``device="cpu"``), with the reference's init rule
(``models/params.py``).  Off the CPU a family with self-attention
(every one but ssm) needs ``ParallelConfig(use_flash_attention=True)``;
rwkv6 has none and needs no flag.  Still to come: ``forward_train``,
the loss and deepseek-v3's multi-token-prediction heads, which only its
loss reads (ROADMAP A.13f).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.layers import (embed_tokens, embedding_schema,
                                      make_norm, unembed)
from repro_torch.models.params import (ParamTree, init_params,
                                       stack_schema)
from repro_torch.models.transformer import DecoderStack

Tensor = torch.Tensor


class Model(nn.Module):
    """A frozen LM backbone of any of the registry's families."""

    def __init__(self, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        # the block functions; the weights are the modules added below
        # (``self.decoder`` is an encoder-decoder's decoder weights)
        self.decoder_stack = (None if cfg.is_encdec
                              else DecoderStack(cfg, self.parallel))
        _, self.norm = make_norm(cfg)
        dev = resolve_device(device)
        if (dev.type != "cpu" and cfg.family != "ssm"
                and not self.parallel.use_flash_attention):
            raise NotImplementedError(
                f"on {dev} attention runs through the flash kernel only: "
                f"pass ParallelConfig(use_flash_attention=True)")
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, tree in init_params(gen, self.schema_of(cfg, self.parallel),
                                      cfg.param_dtype).items():
            self.add_module(name, ParamTree(tree))

    @staticmethod
    def schema_of(cfg: ModelConfig,
                  parallel: Optional[ParallelConfig] = None
                  ) -> Dict[str, Any]:
        """The reference's parameter schema (``Model.schema``) of a model
        of ``cfg``, without building one."""
        if cfg.mtp_depth:
            raise NotImplementedError(
                "multi-token-prediction heads land with the training "
                "slice, beside the loss that reads them (ROADMAP A.13f)")
        norm_schema, _ = make_norm(cfg)
        sch: Dict[str, Any] = {"embed": embedding_schema(cfg)}
        if cfg.is_encdec:
            sch["encoder"] = encdec.encoder_schema(cfg)
            sch["decoder"] = stack_schema(encdec.decoder_layer_schema(cfg),
                                          cfg.num_layers)
        else:
            sch["stack"] = DecoderStack(
                cfg, parallel or ParallelConfig()).schema()
        sch["ln_f"] = norm_schema(cfg.d_model)
        return sch

    @property
    def device(self) -> torch.device:
        """Where the parameters live."""
        return self.embed["embedding"].device

    def _encode(self, frames: Tensor) -> Tensor:
        """An encoder-decoder's encoder output (B, T_src, d)."""
        return encdec.encode(self.encoder, self.cfg,
                             torch.as_tensor(frames, device=self.device),
                             self.parallel)

    def _embed_in(self, tokens: Tensor, frames: Optional[Tensor] = None,
                  patch_embeds: Optional[Tensor] = None) -> Tensor:
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
        x = embed_tokens(self.embed, cfg, torch.as_tensor(tokens,
                                                          device=self.device))
        if patch_embeds is not None:
            pe = torch.as_tensor(patch_embeds, device=self.device).to(
                cfg.compute_dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _hidden(self, tokens: Tensor, frames: Optional[Tensor] = None,
                patch_embeds: Optional[Tensor] = None) -> Tensor:
        """The train forward's hidden states (B, S, d), before ln_f."""
        x = self._embed_in(tokens, frames, patch_embeds)
        if self.cfg.is_encdec:
            return encdec.decoder_train(self.decoder, self.cfg, x,
                                        self._encode(frames), self.parallel)
        return self.decoder_stack.train_hidden(self.stack, x)

    @torch.no_grad()
    def features(self, tokens: Tensor, *, frames: Optional[Tensor] = None,
                 patch_embeds: Optional[Tensor] = None) -> Tensor:
        """(n, S) event tokens (and the model's extras) -> (n, d_model)
        fp32: the final-norm hidden states mean-pooled over the sequence
        (pooled in the compute dtype, as the reference pools them)."""
        h = self.norm(self.ln_f, self._hidden(tokens, frames, patch_embeds))
        return h.mean(dim=1).to(torch.float32)

    def _logits(self, h: Tensor) -> Tensor:
        """Final norm and unembedding: (..., d) -> (..., padded_vocab)
        logits in the compute dtype."""
        return unembed(self.embed, self.cfg, self.norm(self.ln_f, h))

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
                self.decoder, self.cfg, x, cross, self.parallel)
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
        if cfg.is_encdec:
            h, _ = encdec.decoder_decode(self.decoder, cfg, x, cache["self"],
                                         cache["cross"], pos)
        else:
            h, cache = self.decoder_stack.decode_hidden(self.stack, x, cache,
                                                        pos)
        return self._logits(h), cache

    serve_step = decode_step

    def init_cache(self, batch: int, seq_len: int) -> Any:
        """A zero cache for ``batch`` rows of ``seq_len`` positions, on
        the model's device; an encoder-decoder's cross half holds
        ``max_source_positions``."""
        cfg = self.cfg
        if not cfg.is_encdec:
            return self.decoder_stack.init_cache(batch, seq_len,
                                                 device=self.device)
        return {"self": attn.init_cache(cfg, batch, seq_len, cfg.num_layers,
                                        device=self.device),
                "cross": attn.init_cache(cfg, batch, cfg.max_source_positions,
                                         cfg.num_layers, device=self.device)}
