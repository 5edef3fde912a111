"""Dispatch for the final stage's residual Gram: CUDA tensors take the
kernel (kernel.py), CPU tensors the plain version (ref.py)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.residual_gram import kernel as _kernel
from repro_torch.kernels.residual_gram import ref as _ref


def residual_gram(y: torch.Tensor, t: torch.Tensor, my: torch.Tensor,
                  mt: torch.Tensor, phi: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residualize -> moments: (G (p, p), b (p,)), fp32."""
    f32 = torch.float32
    y, t, my, mt, phi = (x.to(f32) for x in (y, t, my, mt, phi))
    if phi.device.type == "cuda":
        return _kernel.residual_gram_cuda(y, t, my, mt, phi)
    if phi.device.type != "cpu":
        raise ValueError(f"residual_gram runs on cuda or cpu, not {phi.device}")
    return _ref.residual_gram_ref(y, t, my, mt, phi)
