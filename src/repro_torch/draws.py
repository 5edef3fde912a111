"""Replicate draws: the seeds, generators and resampling weights of
replicate inference.

Replicate b draws its weights, then its folds, then the inits of any mlp
refit, from its own CPU generator seeded from ``(seed, b)`` alone
(``replicate_generator``), so a B=100 run is a prefix of a B=200 run and
any replicate can be replayed alone.  A leaf module: it imports nothing
of ``repro_torch``, so the estimators of ``repro_torch.core`` import it
at module level, where they import ``repro_torch.inference`` inside the
functions that run inference.  ``repro_torch.inference.bootstrap``
re-exports every name.
"""
from __future__ import annotations

from typing import List

import torch

Tensor = torch.Tensor
_F32 = torch.float32
_MASK64 = (1 << 64) - 1


def derive_seed(seed: int, i: int) -> int:
    """A 63-bit seed derived from ``(seed, i)`` alone (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xBF58476D1CE4E5B9
         ) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def replicate_generator(seed: int, b: int) -> torch.Generator:
    """Replicate b's CPU generator, seeded from ``(seed, b)`` alone."""
    return torch.Generator().manual_seed(derive_seed(seed, b))


def replicate_generators(seed: int, n_replicates: int
                         ) -> List[torch.Generator]:
    """The generators of replicates 0 .. B-1: replicate b's does not
    depend on B, so a B=100 run is a prefix of a B=200 run."""
    return [replicate_generator(seed, b) for b in range(n_replicates)]


def bootstrap_weights(gen: torch.Generator, n: int, scheme: str) -> Tensor:
    """(n,) fp32 per-row resampling weights with mean ≈ 1, on ``gen``'s
    device.

    pairs       multinomial counts (resampling with replacement);
    multiplier  i.i.d. Exp(1) multipliers (the Bayesian bootstrap up to
    bayesian    normalization).
    """
    if scheme == "pairs":
        idx = torch.randint(0, n, (n,), generator=gen, device=gen.device)
        # integer counts: exact in fp32 below 2^24, and on a CUDA
        # generator's device bincount's atomics add integers, so the
        # counts do not depend on the order the atomics land in
        return torch.bincount(idx, minlength=n).to(_F32)
    if scheme in ("multiplier", "bayesian"):
        return torch.empty(n, dtype=_F32, device=gen.device).exponential_(
            1.0, generator=gen)
    raise ValueError(f"unknown bootstrap scheme {scheme!r}")


def replicate_weights(seed: int, ids: Tensor, n: int, scheme: str,
                      device=None):
    """(w (R, n), gens) of the replicates ``ids``: each draws its weights
    first on its own generator (``replicate_generator(seed, b)``);
    ``gens`` are those generators, past that draw, for what each
    replicate draws next."""
    gens = [replicate_generator(seed, b) for b in ids.tolist()]
    w = torch.stack([bootstrap_weights(g, n, scheme) for g in gens])
    return w.to(device), gens
