"""Learning-rate schedules: pure functions of the step, in fp32 (the
reference's ``optim/schedule.py``).  ``step`` is an int or a tensor
(the optimizer state's step count, on its device); the result is a
0-d fp32 tensor beside it."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _step(step) -> Tensor:
    if isinstance(step, Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def linear_schedule(step, *, peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Tensor:
    """Linear warmup from 0 to ``peak`` over ``warmup`` steps, then a
    linear decay to ``floor`` at ``total``."""
    s = _step(step)
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    decay = peak + (floor - peak) * frac
    return torch.where(s < warmup, warm, decay)


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Tensor:
    """Linear warmup, then a half cosine from ``peak`` down to
    ``floor_frac · peak`` at ``total``."""
    s = _step(step)
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    floor = peak * floor_frac
    decay = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, decay)
