"""Device resolution and the fp32 precision switches.

Entry points take ``device=None`` to mean the card: without CUDA they
raise instead of carrying on on the CPU.  ``device="cpu"`` is the
explicit opt-in the tests use.

On the card, float32 matrix products and convolutions must run in full
fp32: the JAX reference computes at highest precision, and TF32 keeps
about three decimal digits — enough to move a DML estimate by more
than the port-vs-reference tolerances.  ``resolve_device`` turns TF32
off for both cuBLAS and cuDNN whenever it hands out a CUDA device, and
with it cuBLAS's reduced-precision reductions of bf16 products: the
reference accumulates its bf16 einsums in fp32, and a split-K reduction
in bf16 would not.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def _fp32_highest() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else the device
    named.  Any CUDA device returned has TF32 switched off."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        _fp32_highest()
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """Any array-like -> a float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)
