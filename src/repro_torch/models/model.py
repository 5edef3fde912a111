"""Model facade: an ``nn.Module`` that owns its parameters.

The counterpart of the reference's ``models/model.py`` for the path this
slice runs: ``features(tokens)`` — the pooled event-sequence
representation that the Dream11 scenario uses as confounders (paper §4).
Parameters are registered under the reference's schema names
(``embed.embedding``, ``stack.layers.attn.wq``, ``ln_f.scale``), so
``state_dict()`` keys are the reference's pytree paths and
``convert.model_params`` loads the reference's weights unchanged.  The
dense (granite), ssm (rwkv6) and hybrid (zamba2) families are built;
an untied ``embed.unembed`` is held but ``features`` does not read it.

``Model(cfg, parallel, device=None, seed=0)`` initialises on a
``torch.Generator`` seeded ``seed`` on ``device`` (the card unless
``device="cpu"``), with the reference's init rule
(``models/params.py``).  Off the CPU a family with attention (dense,
hybrid) needs ``ParallelConfig(use_flash_attention=True)``; rwkv6 has
none and needs no flag.  ``forward_train``, ``prefill``,
``decode_step`` and the moe / vlm / encoder-decoder branches come with
later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import embed_tokens, embedding_schema, make_norm
from repro_torch.models.params import ParamTree, init_params
from repro_torch.models.transformer import DecoderStack

Tensor = torch.Tensor


class Model(nn.Module):
    """A frozen LM backbone of the dense, ssm or hybrid family."""

    def __init__(self, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if cfg.is_encdec:
            raise NotImplementedError(
                "encoder-decoder models land with whisper's slice "
                "(ROADMAP A.13)")
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
                "slice (ROADMAP A.13)")
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
