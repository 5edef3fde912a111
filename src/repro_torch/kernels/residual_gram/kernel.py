"""The historical residual-Gram entry point on the card: a thin wrapper
over the segmented-Gram kernel (kernels/seg_gram) with the residual
builder, one segment.  Replaces
``src/repro/kernels/residual_gram/kernel.py:residual_gram_pallas``.
Its launches count in the seg_gram kernel's ``LAUNCHES`` under
``LAUNCH_KEY``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.seg_gram import kernel as sg_kernel

LAUNCH_KEY = "residual_gram"


def residual_gram_cuda(y: torch.Tensor, t: torch.Tensor, my: torch.Tensor,
                       mt: torch.Tensor, phi: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y, t, my, mt: (n,); phi: (n, p), fp32 CUDA.  (G (p, p), b (p,))."""
    p = phi.shape[1]
    cols = tuple(x.contiguous() for x in (y, t, my, mt))
    gaug = sg_kernel.seg_gram_cuda("residual", phi.contiguous(),
                                   scalars=cols, count_as=LAUNCH_KEY)[0]
    return gaug[:p, :p], gaug[:p, p]
