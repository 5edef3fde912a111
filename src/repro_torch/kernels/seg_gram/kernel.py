"""ctypes binding of the Hopper segmented-Gram kernel (csrc/seg_gram.cu).

``seg_gram_cuda`` takes the raw columns of one of the kernel's seven
builders, checks device, dtype, shape and contiguity, launches the
kernel on the current stream and returns ``(B, S*qL, qR)`` fp32.  It
raises on anything it does not take and whenever the launch returns a
CUDA error; it never falls back to the plain version.  ``LAUNCHES``
counts launches per form (the builder's name, ``<name>_segmented`` for
S > 1, or the ``count_as`` key of an entry point of its own:
``residual_gram`` for the final stage at row_block=0, ``fold_weighted``
for the bootstrap's fold-and-replicate-weighted Grams), one per launch.

Replaces ``src/repro/kernels/seg_gram/kernel.py:seg_gram_pallas``; the
design and its bound on the H100 are in the source note of
``csrc/seg_gram.cu``.
"""
from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "seg_gram.cu"
BUILDERS = {"design": 0, "gram_and_vec": 1, "residual": 2,
            "residual_meat": 3, "residual_direct": 4, "iv": 5, "iv_meat": 6}
# (scalar columns taken, copies of X, appended L columns, appended R
# columns) per builder: qL = copies * dX + appended
_LAYOUT = {"design": ((0,), 1, 0, 0), "gram_and_vec": ((2,), 1, 1, 0),
           "residual": ((4,), 1, 1, 1), "residual_meat": ((4, 5), 1, 0, 0),
           "residual_direct": ((2,), 1, 1, 1), "iv": ((3,), 2, 1, 1),
           "iv_meat": ((3, 4), 1, 0, 0)}
_MEATS = ("residual_meat", "iv_meat")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """The built kernel library (built from SOURCE on first call)."""
    lib, _ = build.load_library(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.seg_gram_split_rows.argtypes = [_I, _I]
        lib.seg_gram_split_rows.restype = _LL
        lib.seg_gram_run.argtypes = [
            _I, _LL, _I, _P,             # builder, n, dX, X
            _P, _P, _P, _P, _P, _LL,     # a0..a4, a_bstride
            _P, _LL, _P, _LL,            # theta, its stride, w, w_bstride
            _P, _I, _I, _I, _I,          # seg, S, B, qL, qR
            _P, _I, _P, _P,              # partial, P, out, stream
        ]
        lib.seg_gram_run.restype = _I
        lib.seg_gram_error_string.argtypes = [_I]
        lib.seg_gram_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def build_log() -> str:
    """What nvcc printed for the kernel (``-Xptxas -v``: registers,
    shared memory, spills), or that the library came from the cache."""
    return build.load_library(SOURCE)[1]


def _check(name: str, x: torch.Tensor, dev: torch.device, dtype,
           shapes: Sequence[tuple]) -> None:
    if x.device != dev:
        raise ValueError(f"seg_gram: {name} is on {x.device}, X on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"seg_gram: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) not in [tuple(s) for s in shapes]:
        raise ValueError(f"seg_gram: {name} has shape {tuple(x.shape)}, "
                         f"expected one of {list(shapes)}")
    if not x.is_contiguous():
        raise ValueError(f"seg_gram: {name} must be contiguous")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else _P(x.data_ptr())


def seg_gram_cuda(builder: str, X: torch.Tensor, *,
                  scalars: Sequence[torch.Tensor] = (),
                  theta: Optional[torch.Tensor] = None,
                  w: Optional[torch.Tensor] = None,
                  seg: Optional[torch.Tensor] = None,
                  n_segments: int = 1,
                  count_as: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel.  ``X`` (n, dX) is the row matrix (the design D
    or phi); ``scalars`` the builder's per-row columns, all (n,) or all
    (B, n) — gram_and_vec: (wg, v); residual: (y, t, my, mt);
    residual_direct: (ry, rt); residual_meat: (y, t, my, mt[, w]); iv:
    (ry, rt, rz); iv_meat: (ry, rt, rz[, w]).  ``theta`` (dX,) or
    (B, dX) for the meats; ``w`` (n,) or (B, n) row weights; ``seg``
    (n,) int32 ids when ``n_segments`` > 1.  ``count_as`` names the
    ``LAUNCHES`` key of a caller that is an entry point of its own
    (default: the form).  Returns (B, n_segments*qL, qR) fp32; raises
    naming the shape if the split-partial buffer does not fit."""
    if builder not in BUILDERS:
        raise NotImplementedError(f"seg_gram has no CUDA builder {builder!r}")
    if X.device.type != "cuda":
        raise ValueError(f"seg_gram_cuda needs CUDA tensors, X is on {X.device}")
    if X.dim() != 2:
        raise ValueError(f"seg_gram: X must be (n, d), got {tuple(X.shape)}")
    dev, f32 = X.device, torch.float32
    n, dX = X.shape
    _check("X", X, dev, f32, [(n, dX)])
    counts, copies, dl, dr = _LAYOUT[builder]
    if len(scalars) not in counts:
        raise ValueError(f"seg_gram[{builder}] takes {counts} scalar columns, "
                         f"got {len(scalars)}")
    S = int(n_segments)
    if S < 1:
        raise ValueError(f"n_segments must be >= 1, got {S}")
    B = 1
    for x in list(scalars) + [x for x in (w, theta) if x is not None]:
        if x.dim() == 2:
            B = max(B, x.shape[0])
    for i, x in enumerate(scalars):
        _check(f"scalars[{i}]", x, dev, f32, [(n,), (B, n)])
        if x.shape != scalars[0].shape:
            raise ValueError(f"seg_gram[{builder}]: the scalar columns "
                             "differ in shape")
    a_b = n if scalars and scalars[0].dim() == 2 else 0
    th_b = 0
    if builder in _MEATS:
        if theta is None:
            raise ValueError(f"seg_gram[{builder}] needs theta")
        _check("theta", theta, dev, f32, [(dX,), (B, dX)])
        th_b = dX if theta.dim() == 2 else 0
    elif theta is not None:
        raise ValueError(f"seg_gram[{builder}] takes no theta")
    w_b = 0
    if w is not None:
        _check("w", w, dev, f32, [(n,), (B, n)])
        w_b = n if w.dim() == 2 else 0
    if S > 1:
        if seg is None:
            raise ValueError("n_segments > 1 needs seg")
        _check("seg", seg, dev, torch.int32, [(n,)])
    elif seg is not None:
        raise ValueError("seg is only taken with n_segments > 1")
    qL, qR = copies * dX + dl, copies * dX + dr

    lib = library()
    rs = lib.seg_gram_split_rows(S * qL, qR)
    P = max(1, -(-n // rs))
    shape = (P, B, S * qL, qR)
    try:
        partial = torch.empty(shape, dtype=f32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"seg_gram[{builder}]: the split-partial buffer {shape} "
            f"({4 * P * B * S * qL * qR / 2 ** 30:.2f} GiB) does not fit on "
            f"{dev}; take fewer replicates per chunk (runtime_chunk)") from e
    out = torch.empty((B, S * qL, qR), dtype=f32, device=dev)
    a = list(scalars) + [None] * (5 - len(scalars))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_gram_run(
            BUILDERS[builder], n, dX, _ptr(X),
            *[_ptr(x) for x in a], a_b,
            _ptr(theta), th_b, _ptr(w), w_b,
            _ptr(seg), S, B, qL, qR,
            _ptr(partial), P, _ptr(out), _P(stream))
    if err != 0:
        msg = lib.seg_gram_error_string(err).decode()
        raise RuntimeError(f"seg_gram[{builder}] launch failed: {msg} ({err})")
    LAUNCHES[count_as or builder + ("_segmented" if S > 1 else "")] += 1
    return out
