"""Plain version of the fused residualize -> Gram moments of the DML
final stage:

    ry = y - my,  rt = t - mt,  Z = rt[:, None] * phi
    G = ZᵀZ (p, p),  b = Zᵀry (p,)
"""
from __future__ import annotations

from typing import Tuple

import torch


def residual_gram_ref(y: torch.Tensor, t: torch.Tensor, my: torch.Tensor,
                      mt: torch.Tensor, phi: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G (p, p), b (p,)) in fp32."""
    f32 = torch.float32
    ry = (y - my).to(f32)
    rt = (t - mt).to(f32)
    z = rt[:, None] * phi.to(f32)
    return z.T @ z, z.T @ ry
