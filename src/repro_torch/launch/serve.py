"""Batched serving driver (the NEXUS deployment path).

The counterpart of the reference's ``launch/serve.py``: requests join a
wave, the wave prefills once through the model's kernels (flash
attention, the GLA and SSD scans), then decodes lock-step, one token
per request per step, against the KV cache and recurrent states.  Slots
that reach their ``max_new_tokens`` keep decoding with the wave, and
their extra tokens are dropped on the way out.

As in the reference, a wave is left-padded to its longest prompt with
token 0, and the padding is not masked: the pad tokens are part of each
shorter prompt, and RoPE positions count them.  Greedy decoding takes
the first index of the largest logit.  A temperature > 0 (the first
request's, for the whole wave) samples on one explicit
``torch.Generator`` on the model's device — the caller's, or one seeded
0.  A wave's extras (whisper's frames, pixtral's patch embeddings) go
to the prefill beside its tokens; pixtral's patches overwrite the first
positions of the left-padded wave, pads included, as in the reference.
Everything runs on the model's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass
class Request:
    """One prompt (S,) of token ids and its generation budget."""

    prompt: Tensor
    max_new_tokens: int = 16
    temperature: float = 0.0   # 0 => greedy


@dataclasses.dataclass
class Completion:
    """The generated tokens and the wave's wall-clock seconds."""

    tokens: List[int]
    latency_s: float


class BatchServer:
    """Wave-batched decoder over a ``repro_torch.models.model.Model``
    (which owns its weights, so no parameter tree is passed)."""

    def __init__(self, model, *, max_seq: int = 512,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.max_seq = max_seq
        self.generator = (generator if generator is not None else
                          torch.Generator(device=model.device).manual_seed(0))
        self._prefill = model.prefill
        self._decode = model.decode_step

    def _sample(self, logits: Tensor, temperature: float) -> Tensor:
        """(B, 1, V) logits -> (B,) next tokens."""
        last = logits[:, -1]
        if temperature <= 0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def serve_wave(self, requests: List[Request],
                   extras: Optional[Dict[str, Any]] = None
                   ) -> List[Completion]:
        """Prefill the wave, then decode until every request has its
        ``max_new_tokens``.  ``extras`` go to the prefill as they are, one
        row per request: an encoder-decoder's ``frames`` (B, T_src,
        d_model), a vlm's ``patch_embeds`` (B, P, d_model)."""
        t0 = time.perf_counter()
        dev = self.model.device
        B = len(requests)
        S = max(int(r.prompt.shape[0]) for r in requests)
        toks = torch.stack([
            F.pad(torch.as_tensor(r.prompt, device=dev).long(),
                  (S - int(r.prompt.shape[0]), 0))          # left-pad
            for r in requests])

        # prefill against a cache sized for prompt + generation budget
        budget = min(S + max(r.max_new_tokens for r in requests),
                     self.max_seq)
        logits, wave_cache = self._prefill(toks, **(extras or {}))
        cache = _splice_prefill(self.model.init_cache(B, budget),
                                wave_cache, S)

        temp = requests[0].temperature
        out_tokens: List[List[int]] = [[] for _ in range(B)]
        nxt = self._sample(logits, temp)
        for i, tok in enumerate(nxt.tolist()):
            out_tokens[i].append(tok)
        steps = max(r.max_new_tokens for r in requests) - 1
        for s in range(steps):
            logits, cache = self._decode(nxt[:, None], cache, S + s)
            nxt = self._sample(logits, temp)
            for i, tok in enumerate(nxt.tolist()):
                if len(out_tokens[i]) < requests[i].max_new_tokens:
                    out_tokens[i].append(tok)
        dt = time.perf_counter() - t0
        return [Completion(tokens=t, latency_s=dt) for t in out_tokens]


def _splice_prefill(full_cache, wave_cache, s: int):
    """Copy the prefill cache (seq length ``s``) into the front of the
    generation-budget cache, in the budget cache's dtype, walking nested
    dicts (an encoder-decoder's {"self", "cross"}).  A leaf of the same
    shape (a recurrent state, a cross cache of ``max_source_positions``
    frames) is the prefill's own tensor; a cross cache of fewer frames
    lands at the front of the zeros, as the reference splices it."""
    if isinstance(full_cache, dict):
        return {k: _splice_prefill(full_cache[k], wave_cache[k], s)
                for k in full_cache}
    dst, src = full_cache, wave_cache
    if dst.shape == src.shape:
        return src
    # KV-style caches differ on the seq axis; find it and splice
    ax = next(a for a in range(dst.dim()) if dst.shape[a] != src.shape[a])
    dst.narrow(ax, 0, src.shape[ax]).copy_(src)
    return dst
