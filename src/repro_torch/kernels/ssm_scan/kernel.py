"""ctypes binding of the Hopper scan kernels (csrc/ssm_scan.cu).

``gla_cuda(q, k, v, w, u, chunk)`` runs the chunked gated-linear-attention
scan: q, k, w (B, H, T, Dk), v (B, H, T, Dv); q, k, v all bf16 or all
fp32, w fp32, u (H, Dk) fp32 for RWKV-6's "bonus" mode or None for
"post" mode.  ``ssd_cuda(q, k, v, a, chunk)`` runs the Mamba2 SSD scan:
q, k (B, T, N), v (B, H, T, P), a (B, H, T), all fp32.  Both return
o in v's dtype and layout and the final state in fp32, (B, H, Dk, Dv)
or (B, H, N, P).

The tensors may be strided views (the models pass (B, T, H, D)
activations transposed to (B, H, T, D)): the kernels read every tensor
through its strides and need only a contiguous last dimension.  The
wrappers check device, dtype, shape, ``T % chunk == 0`` and the shared
memory a block needs, launch on the current stream and raise on
anything else and whenever the launch returns a CUDA error; they never
fall back to the plain version.  ``LAUNCHES["gla"]`` and
``LAUNCHES["ssd"]`` count launches, one per call.

Replaces ``src/repro/kernels/ssm_scan/kernel.py:gla_pallas`` and
``:ssd_pallas``; the design and the bounds on the H100 are in the source
note of ``csrc/ssm_scan.cu``.
"""
from __future__ import annotations

import collections
import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
Tensor = torch.Tensor


def library() -> ctypes.CDLL:
    """The built kernel library (built from SOURCE on first call)."""
    lib, _ = build.load_library(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.ssm_gla_run.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P,   # dtype, q, k, v, w, u, o, s
            _P, _I, _I, _I, _I, _I, _I, _P,   # strides, B, H, T, Dk, Dv, C, stream
        ]
        lib.ssm_ssd_run.argtypes = [
            _P, _P, _P, _P, _P, _P,           # q, k, v, a, o, s
            _P, _I, _I, _I, _I, _I, _I, _P,   # strides, B, H, T, N, P, C, stream
        ]
        lib.ssm_gla_run.restype = lib.ssm_ssd_run.restype = _I
        for fn in (lib.ssm_gla_smem_bytes, lib.ssm_ssd_smem_bytes):
            fn.argtypes = [_I, _I, _I]
            fn.restype = _LL
        lib.ssm_smem_max.restype = _I
        lib.ssm_scan_error_string.argtypes = [_I]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def build_log() -> str:
    """What nvcc printed for the kernels (``-Xptxas -v``), or that the
    library came from the cache."""
    return build.load_library(SOURCE)[1]


def _check(name: str, x: Tensor, dev: torch.device, dtypes,
           shape: Sequence[int], last_contiguous: bool = True) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} is {x.dtype}; takes {sorted(map(str, dtypes))}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if last_contiguous and x.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last dimension")


def _strides(*xs_bht) -> ctypes.Array:
    """15 element strides, (b, h, t) per tensor."""
    flat = [int(s) for triple in xs_bht for s in triple]
    return (ctypes.c_longlong * len(flat))(*flat)


def _bht(x: Tensor) -> Tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def _run(lib, fn, smem: int, what: str, *args) -> None:
    if smem > lib.ssm_smem_max():
        raise ValueError(f"{what}: chunk and head sizes need {smem} bytes of "
                         f"shared memory, more than {lib.ssm_smem_max()}")
    err = fn(*args)
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _stream(dev: torch.device) -> _P:
    return _P(torch.cuda.current_stream(dev).cuda_stream)


def gla_cuda(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
             u: Optional[Tensor] = None, *, chunk: int = 64
             ) -> Tuple[Tensor, Tensor]:
    """Launch the GLA scan; see the module docstring."""
    if q.device.type != "cuda":
        raise ValueError(f"gla_cuda needs CUDA tensors, q is on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"gla: q must be (B, H, T, Dk), got {tuple(q.shape)}")
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"gla: q is {q.dtype}; q, k, v must all be float32 "
                        f"or all bfloat16")
    _check("gla: q", q, dev, (q.dtype,), (B, H, T, Dk))
    _check("gla: k", k, dev, (q.dtype,), (B, H, T, Dk))
    _check("gla: v", v, dev, (q.dtype,), (B, H, T, Dv))
    _check("gla: w", w, dev, (torch.float32,), (B, H, T, Dk))
    if u is not None:
        _check("gla: u", u, dev, (torch.float32,), (H, Dk))
        u = u.contiguous()
    if chunk < 1 or T % chunk:
        raise ValueError(f"gla: T={T} is not a multiple of chunk={chunk}")
    o = torch.empty_like(v)                  # v's layout
    s = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        _run(lib, lib.ssm_gla_run, lib.ssm_gla_smem_bytes(chunk, Dk, Dv),
             "gla", _DTYPES[q.dtype], _P(q.data_ptr()), _P(k.data_ptr()),
             _P(v.data_ptr()), _P(w.data_ptr()),
             _P(u.data_ptr() if u is not None else None), _P(o.data_ptr()),
             _P(s.data_ptr()),
             _strides(_bht(q), _bht(k), _bht(v), _bht(w), _bht(o)),
             B, H, T, Dk, Dv, chunk, _stream(dev))
    LAUNCHES["gla"] += 1
    return o, s


def ssd_cuda(q: Tensor, k: Tensor, v: Tensor, a: Tensor, *,
             chunk: int = 32) -> Tuple[Tensor, Tensor]:
    """Launch the SSD scan; see the module docstring."""
    if q.device.type != "cuda":
        raise ValueError(f"ssd_cuda needs CUDA tensors, q is on {q.device}")
    if q.dim() != 3 or v.dim() != 4:
        raise ValueError(f"ssd: q must be (B, T, N) and v (B, H, T, P), got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    dev = q.device
    f32 = (torch.float32,)
    _check("ssd: q", q, dev, f32, (B, T, N))
    _check("ssd: k", k, dev, f32, (B, T, N))
    _check("ssd: v", v, dev, f32, (B, H, T, P))
    _check("ssd: a", a, dev, f32, (B, H, T), last_contiguous=False)
    if chunk < 1 or T % chunk:
        raise ValueError(f"ssd: T={T} is not a multiple of chunk={chunk}")
    o = torch.empty_like(v)
    s = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    qs = (q.stride(0), 0, q.stride(1))
    ks = (k.stride(0), 0, k.stride(1))
    lib = library()
    with torch.cuda.device(dev):
        _run(lib, lib.ssm_ssd_run, lib.ssm_ssd_smem_bytes(chunk, N, P), "ssd",
             _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
             _P(a.data_ptr()), _P(o.data_ptr()), _P(s.data_ptr()),
             _strides(qs, ks, _bht(v), _bht(a), _bht(o)),
             B, H, T, N, P, chunk, _stream(dev))
    LAUNCHES["ssd"] += 1
    return o, s
