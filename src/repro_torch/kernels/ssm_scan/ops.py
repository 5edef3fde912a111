"""Dispatch for the chunked scans.

``gla`` and ``ssd`` take the reference's layouts (``ssm_scan/ops.py``)
and its chunk rule: ``chunk`` is halved until it divides T.  A CUDA
tensor goes to the Hopper kernel (kernel.py), a CPU tensor to the plain
chunked version (ref.py).  Nothing else is taken, and nothing falls back.

The kernels have no backward (nor have the reference's Pallas scans): on
the card, a call under grad whose inputs require grad raises
``NotImplementedError`` (ROADMAP A.13g) rather than return a tensor cut
off from its inputs' gradients.  On the CPU autograd differentiates the
plain scans.

``gla_decode_step`` and ``ssd_decode_step`` (serving: one new token
against the recurrent state a prefill's scan left) are plain torch on
both devices, as they are plain ``jnp`` in the reference
(``ssm_scan/ops.py``): per head, one rank-1 update of the (Dk, Dv)
state and one readout, a few hundred bytes of state read and written
per product — bound by memory, with nothing for a tiled kernel to
reuse.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref

Tensor = torch.Tensor


def _fit_chunk(chunk: int, T: int) -> int:
    while chunk > 1 and T % chunk:
        chunk //= 2
    return chunk


def _device(x: Tensor, what: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return x.device.type


def _no_grad_on_card(what: str, *xs) -> None:
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise NotImplementedError(
            f"{what} on the card has no backward: the scans under autograd "
            f"on the card are ROADMAP A.13g (train on the CPU, or call it "
            f"under torch.no_grad())")


def gla(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
        u: Optional[Tensor] = None, *, chunk: int = 64
        ) -> Tuple[Tensor, Tensor]:
    """Gated-linear-attention scan; see ssm_scan.ref for semantics.
    q,k,w (B,H,T,Dk); v (B,H,T,Dv); u (H,Dk) or None."""
    chunk = _fit_chunk(chunk, q.shape[2])
    if _device(q, "gla") == "cuda":
        _no_grad_on_card("gla", q, k, v, w, u)
        return _kernel.gla_cuda(q, k, v, w, u, chunk=chunk)
    return _ref.gla_chunked_ref(q, k, v, w, u, chunk=chunk)


def ssd(q: Tensor, k: Tensor, v: Tensor, a: Tensor, *, chunk: int = 32
        ) -> Tuple[Tensor, Tensor]:
    """Mamba2 SSD scan. q,k (B,T,N); v (B,H,T,P); a (B,H,T)."""
    chunk = _fit_chunk(chunk, q.shape[1])
    if _device(q, "ssd") == "cuda":
        _no_grad_on_card("ssd", q, k, v, a)
        return _kernel.ssd_cuda(q, k, v, a, chunk=chunk)
    return _ref.ssd_chunked_ref(q, k, v, a, chunk=chunk)


def gla_decode_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                    w: Tensor, u: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """One token of the GLA recurrence: state (B, H, Dk, Dv) fp32;
    q, k, w (B, H, Dk); v (B, H, Dv); u (H, Dk) or None.  Returns
    (new state, o (B, H, Dv)); mixed dtypes promote as in the
    reference (a bf16 q against the fp32 state reads out in fp32)."""
    return _ref.gla_step(state, q, k, v, w, u)


def ssd_decode_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                    a: Tensor) -> Tuple[Tensor, Tensor]:
    """One token of the SSD recurrence: state (B, H, N, P); q, k (B, N);
    v (B, H, P); a (B, H).  Returns (new state, o (B, H, P))."""
    return _ref.ssd_step(state, q, k, v, a)
