"""ctypes binding of the Hopper flash-attention kernel
(csrc/flash_attention.cu).

``flash_attention_cuda`` takes q (B, Sq, H, Dqk), k (B, Sk, KV, Dqk)
and v (B, Sk, KV, Dv) in the model's layout, bf16 or fp32 (all three
alike), contiguous, on one CUDA device; checks all of that, launches the
kernel on the current stream and returns o (B, Sq, H, Dv) in q's dtype.
Any Sq, Sk: the kernel masks ragged tails.  (Dqk, Dv) must be one of
``HEAD_DIMS``: 16, 32, 64 or 128 for both, or MLA's (192, 128).  The
default scale is 1/sqrt(Dqk).  With ``return_lse=True`` it returns (o,
lse): lse (B, H, Sq) fp32, each query row's logsumexp of its scaled,
soft-capped scores, which the backward reads (``ops.py``); o is the
same bits with or without it.  It raises on anything it does not take
and whenever the launch returns a CUDA error; it never falls back to the
plain version.  ``LAUNCHES["flash_attention"]`` counts launches, one
per call, ``LAUNCHES["flash_attention[lse]"]`` those of them that wrote
the LSE, ``LAUNCHES_BY_DIMS[(Dqk, Dv)]`` the launches by head dims and
``LAUNCHES_BY_FORM["causal" | "bidirectional"]`` by mask.

Replaces ``src/repro/kernels/flash_attention/kernel.py:
flash_attention_pallas``; the design and its bound on the H100 are in the
source note of ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# (q.k^T head dim, v head dim) pairs the kernel is instantiated for
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_BY_DIMS: collections.Counter = collections.Counter()
LAUNCHES_BY_FORM: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def library() -> ctypes.CDLL:
    """The built kernel library (built from SOURCE on first call)."""
    lib, _ = build.load_library(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.flash_attention_run.argtypes = [
            _I, _P, _P, _P, _P, _P,      # dtype, q, k, v, o, lse
            _I, _I, _I, _I, _I,          # B, Sq, Sk, H, KV
            _I, _I,                      # Dqk, Dv
            _F, _F, _I, _P,              # scale, softcap, causal, stream
        ]
        lib.flash_attention_run.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def build_log() -> str:
    """What nvcc printed for the kernel (``-Xptxas -v``), or that the
    library came from the cache."""
    return build.load_library(SOURCE)[1]


def _pairs(B: int, H: int, Sq: int, Sk: int, causal: bool) -> float:
    """(query, key) pairs a causal or bidirectional pass needs."""
    return B * H * (Sq * (Sq + 1) / 2 if causal else Sq * Sk)


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, lse: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one forward launch: the QK and PV products over
    the pairs it needs, and q, k, v read and o (and the fp32 LSE rows)
    written once."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    flops = 2.0 * _pairs(B, H, Sq, Sk, causal) * (D + Dv)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + B * Sq * H * Dv) \
        + (4 * B * H * Sq if lse else 0)
    return flops, nbytes


def bwd_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True) -> Tuple[float, float]:
    """(flops, bytes) of the blocked backward (``ops.
    flash_attention_bwd_blocks``) over the pairs it needs: the scores
    again (D), dv and dp (Dv each), dk and dq (D each); q, k, v and
    their gradients, o and do, and the LSE rows moved once."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    flops = 2.0 * _pairs(B, H, Sq, Sk, causal) * (3 * D + 2 * Dv)
    nbytes = q.element_size() * (2 * (q.numel() + k.numel() + v.numel())
                                 + 2 * B * Sq * H * Dv) + 4 * B * H * Sq
    return flops, nbytes


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, softcap: float = 0.0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the kernel on (B, S, heads, D) tensors: o, or (o, lse)
    with ``return_lse``; see the module docstring."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, q is on "
                         f"{q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}; q, k, v "
                            f"must all be float32 or all bfloat16")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, heads, "
                             f"D), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if tuple(k.shape) != (B, Sk, KV, D) or \
            tuple(v.shape) != (B, Sk, KV, Dv):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Sk, KV, Dqk) and "
                         f"(B, Sk, KV, Dv) with B={B}, Dqk={D}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q.k {D}, v {Dv}) "
                         f"not in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} heads do not group over "
                         f"{KV} kv heads")
    if min(B, Sq, Sk) < 1 or max(B, H) > 65535:
        raise ValueError(f"flash_attention: unsupported sizes B={B} Sq={Sq} "
                         f"Sk={Sk} H={H}")
    sc = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    out = q.new_empty((B, Sq, H, Dv))
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_run(
            _DTYPES[q.dtype], _P(q.data_ptr()), _P(k.data_ptr()),
            _P(v.data_ptr()), _P(out.data_ptr()),
            _P(lse.data_ptr() if return_lse else None), B, Sq, Sk, H, KV, D,
            Dv, sc, float(softcap), int(bool(causal)), _P(stream))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    LAUNCHES["flash_attention"] += 1
    op_cost.charge("flash_attention",
                   *cost(q, k, v, causal=causal, lse=return_lse))
    LAUNCHES_BY_DIMS[(D, Dv)] += 1
    LAUNCHES_BY_FORM["causal" if causal else "bidirectional"] += 1
    if return_lse:
        LAUNCHES["flash_attention[lse]"] += 1
        return out, lse
    return out
