"""Model facade: an ``nn.Module`` that owns its parameters.

The counterpart of the reference's ``models/model.py`` for the dense
(granite, yi, phi4-mini, chatglm3), moe (arctic, deepseek-v3: MLA and
MoE), ssm (rwkv6) and hybrid (zamba2) families:
``features(tokens)`` — the pooled event-sequence representation that
the Dream11 scenario uses as confounders (paper §4) — and the serving
forms ``prefill``, ``decode_step`` (alias ``serve_step``) and
``init_cache``, which ``launch/serve.py``'s ``BatchServer`` drives.
Parameters are registered under the reference's schema names
(``embed.embedding``, ``stack.layers.attn.wq``, ``ln_f.scale``), so
``state_dict()`` keys are the reference's pytree paths and
``convert.model_params`` loads the reference's weights unchanged;
``convert.cache`` carries a reference cache across the same way.

``Model(cfg, parallel, device=None, seed=0)`` initialises on a
``torch.Generator`` seeded ``seed`` on ``device`` (the card unless
``device="cpu"``), with the reference's init rule
(``models/params.py``).  Off the CPU a family with attention (dense,
moe, hybrid) needs ``ParallelConfig(use_flash_attention=True)``; rwkv6
has none and needs no flag.  Still to come: ``forward_train``, the loss
and deepseek-v3's multi-token-prediction heads, which only its loss
reads (ROADMAP A.13f); the encoder-decoder and vlm branches (A.13e).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (embed_tokens, embedding_schema,
                                      make_norm, unembed)
from repro_torch.models.params import ParamTree, init_params
from repro_torch.models.transformer import DecoderStack

Tensor = torch.Tensor


class Model(nn.Module):
    """A frozen LM backbone of the dense, moe, ssm or hybrid family."""

    def __init__(self, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if cfg.is_encdec:
            raise NotImplementedError(
                "encoder-decoder models land with whisper's slice "
                "(ROADMAP A.13e)")
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.decoder = DecoderStack(cfg, self.parallel)
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
        stack = DecoderStack(cfg, parallel or ParallelConfig())
        return {"embed": embedding_schema(cfg), "stack": stack.schema(),
                "ln_f": norm_schema(cfg.d_model)}

    @property
    def device(self) -> torch.device:
        """Where the parameters live."""
        return self.embed["embedding"].device

    @torch.no_grad()
    def features(self, tokens: Tensor) -> Tensor:
        """(n, S) event tokens -> (n, d_model) fp32: the final-norm hidden
        states mean-pooled over the sequence (pooled in the compute
        dtype, as the reference pools them)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embed, self.cfg, tokens)
        h = self.decoder.train_hidden(self.stack, x)
        h = self.norm(self.ln_f, h)
        return h.mean(dim=1).to(torch.float32)

    def _logits(self, h: Tensor) -> Tensor:
        """Final norm and unembedding: (..., d) -> (..., padded_vocab)
        logits in the compute dtype."""
        return unembed(self.embed, self.cfg, self.norm(self.ln_f, h))

    @torch.no_grad()
    def prefill(self, tokens: Tensor) -> Tuple[Tensor, Any]:
        """Full forward over the prompt (B, S): (last-token logits (B, 1,
        V), the cache of S positions)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embed, self.cfg, tokens)
        h, cache = self.decoder.prefill_hidden(self.stack, x)
        return self._logits(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens: Tensor, cache: Any, pos: int
                    ) -> Tuple[Tensor, Any]:
        """One new token per row.  tokens: (B, 1); ``pos`` the index the
        new token is written at (the cache holds positions < pos).
        Returns (logits (B, 1, V), cache).  The cache is written IN
        PLACE and the same tree returned (the reference donates it to
        the jitted step), so a caller that needs the old cache keeps a
        copy."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = embed_tokens(self.embed, self.cfg, tokens)
        h, cache = self.decoder.decode_hidden(self.stack, x, cache, int(pos))
        return self._logits(h), cache

    serve_step = decode_step

    def init_cache(self, batch: int, seq_len: int) -> Any:
        """A zero cache for ``batch`` rows of ``seq_len`` positions, on
        the model's device."""
        return self.decoder.init_cache(batch, seq_len, device=self.device)
