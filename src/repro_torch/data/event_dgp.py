"""Synthetic user event sequences — the Dream11 scenario of
``examples/causal_backbone.py``, drawn on a ``torch.Generator``.

A user's sequence encodes a latent engagement e ~ U(0, 1): each event is
the "deposit-screen" token 7 with probability e, else uniform in
[8, vocab).  Engagement confounds both the treatment (a promo,
T ~ Bern(sigmoid(3(e - 1/2)))) and the outcome (deposits,
Y = 2T + 4e + 0.5·eps).  The true effect is 2.0.  A mean-pooled
embedding is affine in the share of token 7, so even an untrained
backbone's features can identify the confounder.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data.causal_dgp import _generator
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
_F32 = torch.float32
SPECIAL_TOKEN = 7


@dataclasses.dataclass(frozen=True)
class EventData:
    """User event sequences with a known treatment effect."""

    tokens: Tensor       # (n, S) int64 event ids
    t: Tensor            # (n,) treatment
    y: Tensor            # (n,) outcome
    engagement: Tensor   # (n,) the latent confounder
    true_ate: float


def make_event_data(n: int, seq_len: int, vocab_size: int, *,
                    seed: int = 0, gen: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> EventData:
    """n users of seq_len events over a vocab of vocab_size ids."""
    dev = resolve_device(device)
    g = _generator(gen, seed, dev)
    e = torch.rand(n, generator=g, device=dev, dtype=_F32)
    special = torch.rand((n, seq_len), generator=g, device=dev) < e[:, None]
    rand_tok = torch.randint(8, vocab_size, (n, seq_len), generator=g,
                             device=dev)
    tokens = torch.where(special, torch.full_like(rand_tok, SPECIAL_TOKEN),
                         rand_tok)
    t = torch.bernoulli(torch.sigmoid(3.0 * (e - 0.5)), generator=g)
    y = 2.0 * t + 4.0 * e + 0.5 * torch.randn(n, generator=g, device=dev)
    return EventData(tokens=tokens, t=t, y=y, engagement=e, true_ate=2.0)
