"""Synthetic token streams for LM training (the reference's
``data/lm_data.py``).

The stream is a noisy affine bigram process: with probability
``1 - EPS_NOISE`` the next token is ``(A_MULT·t + C_ADD) mod V``, else
uniform.  It is deterministic in (seed, step) — restart-safe: a run
resumed at step s sees the batch a fresh run saw at step s — learnable
(CE floor ``bigram_ce_floor``), and made on the host with no I/O.
torch cannot replay ``jax.random``, so the port draws from its own
``torch.Generator`` (``step_generator``), the same process with other
draws.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

Tensor = torch.Tensor

A_MULT = 5
C_ADD = 13
EPS_NOISE = 0.2


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for batch ``step`` of the stream ``seed``: its seed
    is a ``SeedSequence`` of the pair, so neighbouring steps and seeds
    draw unrelated streams."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s) & (2 ** 63 - 1))


def synthetic_tokens(gen: torch.Generator, batch: int, seq_len: int,
                     vocab_size: int) -> Tensor:
    """(batch, seq_len + 1) int32 on ``gen``'s device — one extra
    position to split into (inputs, labels) without a second sample."""
    dev = gen.device
    t = torch.randint(0, vocab_size, (batch,), generator=gen, device=dev)
    noisy = torch.rand((batch, seq_len), generator=gen, device=dev) \
        < EPS_NOISE
    uniform = torch.randint(0, vocab_size, (batch, seq_len), generator=gen,
                            device=dev)
    out = [t]
    for j in range(seq_len):
        t = torch.where(noisy[:, j], uniform[:, j],
                        (A_MULT * t + C_ADD) % vocab_size)
        out.append(t)
    return torch.stack(out, dim=1).to(torch.int32)


def split_tokens(toks: Tensor) -> Dict[str, Tensor]:
    """(B, S + 1) tokens -> {"tokens": the first S, "labels": the last S}."""
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_batch(gen: torch.Generator, batch: int, seq_len: int,
             vocab_size: int) -> Dict[str, Tensor]:
    """One batch {"tokens", "labels"}, each (batch, seq_len) int32."""
    return split_tokens(synthetic_tokens(gen, batch, seq_len, vocab_size))


def lm_batch_stream(seed: int, batch: int, seq_len: int, vocab_size: int,
                    start_step: int = 0) -> Iterator[Dict[str, Tensor]]:
    """The deterministic (step -> batch) stream from ``start_step``:
    resuming at step s replays what a fresh run saw at step s."""
    step = start_step
    while True:
        yield lm_batch(step_generator(seed, step), batch, seq_len,
                       vocab_size)
        step += 1


def bigram_ce_floor(vocab_size: int) -> float:
    """The stream's analytic CE floor (nats a token)."""
    e = EPS_NOISE
    # H = -(1-e+e/V)·ln(1-e+e/V) - (V-1)·(e/V)·ln(e/V)
    p_hit = (1 - e) + e / vocab_size
    p_other = e / vocab_size
    return float(-(p_hit * np.log(p_hit)
                   + (vocab_size - 1) * p_other * np.log(p_other)))
