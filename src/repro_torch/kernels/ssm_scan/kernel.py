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
through its strides and need only a contiguous last dimension.

Each scan has two forms, and the route between them is by shape
(``gla_plan`` / ``ssd_plan``, plain Python):

* ``tiled`` — head size 64 (Dk = Dv = 64; N = P = 64), chunk 1, 2, 4,
  8, 16 or 32, every row 16-byte aligned (data pointers and (b, h, t)
  strides multiples of 16 bytes; the SSD's a is read 4 bytes at a time
  and may lie anywhere).  The models' main paths take it: rwkv6-3b's
  GLA (bf16 r/k/v, chunk 16) and zamba2-1.2b's SSD (chunk 32).  The SSD
  runs a block per (b, group of G heads), G = 2 where H is even, else 1.
* ``generic`` — everything else whose tiles fit in a block's shared
  memory (any head size, Dk != Dv, any chunk, unaligned views).

A shape neither form takes raises ``ValueError`` (shared memory).  Both
forms give the same bits (the source note says why).  The wrappers also
check device, dtype, shape and ``T % chunk == 0``, launch on the current
stream and raise on anything else and whenever the launch returns a
CUDA error; they never fall back to the plain version.  ``LAUNCHES``
counts launches, one per call: ``"gla"`` and ``"ssd"`` in all, and
``"gla:tiled"``, ``"gla:generic"``, ``"ssd:tiled"``, ``"ssd:generic"``
by form.  ``form=`` on a wrapper asks for one form (a test of the two
forms' agreement); without it the shape decides.

Replaces ``src/repro/kernels/ssm_scan/kernel.py:gla_pallas`` and
``:ssd_pallas``; the design and the bounds on the H100 are in the source
note of ``csrc/ssm_scan.cu``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FORMS = {"generic": 0, "tiled": 1}

# Mirrors of the source's constants: a block's dynamic shared memory
# (``ssm_smem_max()``), the tiled forms' head size, chunks and threads a
# head, and the generic forms' threads a block.
SMEM_MAX = 232448
TILED_HEAD = 64
TILED_CHUNKS = (1, 2, 4, 8, 16, 32)
TILED_THREADS = 128
GENERIC_THREADS = 256

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the form, its grid and block, the shared memory a
    block needs (bytes), the chunk and the heads a block (SSD tiled)."""

    scan: str
    form: str
    chunk: int
    grid: int
    threads: int
    smem: int
    group: int = 1

    @property
    def key(self) -> str:
        return f"{self.scan}:{self.form}"


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def gla_smem(form: str, chunk: int, Dk: int, Dv: int, itemsize: int,
             bonus: bool) -> int:
    """Bytes of shared memory a GLA block needs (the source's
    ``ssm_gla_smem_bytes``)."""
    C = chunk
    if form == "generic":
        fl = 6 * C * (Dk + 1) + C * Dv + Dk * Dv + C * (C + 1) + Dk
    else:
        D = TILED_HEAD
        fl = (D * D + 5 * C * D + _pad4(C * C) + D + 3 * C * D * itemsize // 4
              + (2 * C * D if bonus else 0))
    return 4 * fl


def ssd_smem(form: str, chunk: int, N: int, P: int, group: int = 1) -> int:
    """Bytes of shared memory an SSD block needs (the source's
    ``ssm_ssd_smem_bytes``)."""
    C = chunk
    if form == "generic":
        fl = 2 * C * (N + 1) + C * P + N * P + C * (C + 1) + 2 * C
    else:
        D, C4 = TILED_HEAD, _pad4(C)
        fl = 2 * C * D + group * (D * D + 3 * C * D + _pad4(C * C)
                                  + 8 * C4 + 8)
    return 4 * fl


def _pick(scan: str, form: Optional[str], tiled_ok: bool, why: str,
          plans) -> Plan:
    """The form asked for, or the tiled form where it takes the shape,
    else the generic one; raises if the chosen form does not fit."""
    if form is not None and form not in FORMS:
        raise ValueError(f"{scan}: form {form!r}; forms are {sorted(FORMS)}")
    if form == "tiled" and not tiled_ok:
        raise ValueError(f"{scan}: the tiled form does not take this shape "
                         f"({why})")
    plan = plans("tiled" if form != "generic" and tiled_ok else "generic")
    if plan.smem > SMEM_MAX:
        raise ValueError(f"{scan}: chunk and head sizes need {plan.smem} bytes "
                         f"of shared memory, more than {SMEM_MAX}")
    return plan


def _check_chunk(scan: str, T: int, chunk: int) -> None:
    if chunk < 1 or T % chunk:
        raise ValueError(f"{scan}: T={T} is not a multiple of chunk={chunk}")


def gla_plan(B: int, H: int, T: int, Dk: int, Dv: int, chunk: int,
             itemsize: int, bonus: bool, aligned: bool = True,
             form: Optional[str] = None) -> Plan:
    """The GLA launch for these sizes: q, k, v of ``itemsize`` bytes
    (4 fp32, 2 bf16), ``aligned`` whether every row is 16-byte aligned."""
    _check_chunk("gla", T, chunk)
    why = []
    if not (Dk == Dv == TILED_HEAD):
        why.append(f"Dk={Dk}, Dv={Dv}, not {TILED_HEAD}")
    if chunk not in TILED_CHUNKS:
        why.append(f"chunk {chunk} not in {TILED_CHUNKS}")
    if not aligned:
        why.append("rows not 16-byte aligned")

    def plan(f):
        return Plan("gla", f, chunk, B * H,
                    TILED_THREADS if f == "tiled" else GENERIC_THREADS,
                    gla_smem(f, chunk, Dk, Dv, itemsize, bonus))
    return _pick("gla", form, not why, "; ".join(why), plan)


def ssd_plan(B: int, H: int, T: int, N: int, P: int, chunk: int,
             aligned: bool = True, form: Optional[str] = None) -> Plan:
    """The SSD launch for these sizes; the tiled form takes heads in
    groups of 2 where H is even."""
    _check_chunk("ssd", T, chunk)
    why = []
    if not (N == P == TILED_HEAD):
        why.append(f"N={N}, P={P}, not {TILED_HEAD}")
    if chunk not in TILED_CHUNKS:
        why.append(f"chunk {chunk} not in {TILED_CHUNKS}")
    if not aligned:
        why.append("rows not 16-byte aligned")
    G = 2 if H % 2 == 0 else 1

    def plan(f):
        if f == "tiled":
            return Plan("ssd", f, chunk, B * (H // G), TILED_THREADS * G,
                        ssd_smem(f, chunk, N, P, G), G)
        return Plan("ssd", f, chunk, B * H, GENERIC_THREADS,
                    ssd_smem(f, chunk, N, P))
    return _pick("ssd", form, not why, "; ".join(why), plan)


def library() -> ctypes.CDLL:
    """The built kernel library (built from SOURCE on first call)."""
    lib, _ = build.load_library(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.ssm_gla_run.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _P, _P,   # form, dtype, q, k, v, w, u, o, s
            _P, _I, _I, _I, _I, _I, _I, _P,       # strides, B, H, T, Dk, Dv, C, stream
        ]
        lib.ssm_ssd_run.argtypes = [
            _I, _I, _P, _P, _P, _P, _P, _P,       # form, G, q, k, v, a, o, s
            _P, _I, _I, _I, _I, _I, _I, _P,       # strides, B, H, T, N, P, C, stream
        ]
        lib.ssm_gla_run.restype = lib.ssm_ssd_run.restype = _I
        lib.ssm_gla_smem_bytes.argtypes = [_I, _I, _I, _I, _I, _I]
        lib.ssm_ssd_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
        lib.ssm_gla_smem_bytes.restype = lib.ssm_ssd_smem_bytes.restype = _LL
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


def _rows_aligned(x: Tensor, bht: Sequence[int]) -> bool:
    """Whether x's data pointer and (b, h, t) strides are multiples of
    16 bytes."""
    return (x.data_ptr() % 16 == 0
            and all(s * x.element_size() % 16 == 0 for s in bht))


def _run(lib, fn, what: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _stream(dev: torch.device) -> _P:
    return _P(torch.cuda.current_stream(dev).cuda_stream)


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def gla_cost(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
             u: Optional[Tensor], chunk: int) -> Tuple[float, int]:
    """(flops, bytes) of one GLA launch: per chunk the causal pairs' QK
    and PV products and the state's qS and kᵀv; r, k, v, w (and u) read,
    o (v's dtype) and the fp32 state written once."""
    B, H, T, Dk = q.shape
    Dv = v.shape[-1]
    tri = chunk * (chunk + 1) // 2
    flops = B * H * (T // chunk) * (2 * tri * (Dk + Dv)
                                    + 2 * chunk * Dk * Dv * 2)
    nbytes = _nbytes(q, k, v, w, u) + v.element_size() * B * H * T * Dv \
        + 4 * B * H * Dk * Dv
    return flops, nbytes


def gla_bwd_cost(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
                 u: Optional[Tensor], chunk: int) -> Tuple[float, int]:
    """(flops, bytes) of the plain chunked backward (``ops.
    gla_bwd_chunks``): twice the forward's products; the inputs and their
    gradients, and do."""
    B, H, T, _ = q.shape
    flops, _ = gla_cost(q, k, v, w, u, chunk)
    return 2 * flops, 2 * _nbytes(q, k, v, w, u) + \
        v.element_size() * B * H * T * v.shape[-1]


def ssd_cost(q: Tensor, k: Tensor, v: Tensor, a: Tensor,
             chunk: int) -> Tuple[float, int]:
    """(flops, bytes) of one SSD launch: per chunk the shared qkᵀ over
    the causal pairs, each head's PV and the state's qS and kᵀv; q, k,
    v, a read, o (v's dtype) and the fp32 state written once."""
    B, T, N = q.shape
    H, P = v.shape[1], v.shape[-1]
    tri = chunk * (chunk + 1) // 2
    flops = (B * (T // chunk) * 2 * tri * N
             + B * H * (T // chunk) * (2 * tri * P + 2 * 2 * chunk * N * P))
    nbytes = _nbytes(q, k, v, a) + v.element_size() * B * H * T * P \
        + 4 * B * H * N * P
    return flops, nbytes


def ssd_bwd_cost(q: Tensor, k: Tensor, v: Tensor, a: Tensor,
                 chunk: int) -> Tuple[float, int]:
    """(flops, bytes) of the plain chunked backward (``ops.
    ssd_bwd_chunks``): twice the forward's products; the inputs and their
    gradients, and do."""
    B, H, T, P = v.shape
    flops, _ = ssd_cost(q, k, v, a, chunk)
    return 2 * flops, 2 * _nbytes(q, k, v, a) + v.element_size() * B * H * T * P


def gla_cuda(q: Tensor, k: Tensor, v: Tensor, w: Tensor,
             u: Optional[Tensor] = None, *, chunk: int = 64,
             form: Optional[str] = None) -> Tuple[Tensor, Tensor]:
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
    _check_chunk("gla", T, chunk)
    o = torch.empty_like(v)                  # v's layout
    s = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    st = [_bht(x) for x in (q, k, v, w, o)]
    aligned = all(_rows_aligned(x, b) for x, b in zip((q, k, v, w, o), st))
    plan = gla_plan(B, H, T, Dk, Dv, chunk, q.element_size(), u is not None,
                    aligned, form)
    lib = library()
    with torch.cuda.device(dev):
        _run(lib, lib.ssm_gla_run, f"gla ({plan.form})", FORMS[plan.form],
             _DTYPES[q.dtype], _P(q.data_ptr()), _P(k.data_ptr()),
             _P(v.data_ptr()), _P(w.data_ptr()),
             _P(u.data_ptr() if u is not None else None), _P(o.data_ptr()),
             _P(s.data_ptr()), _strides(*st), B, H, T, Dk, Dv, chunk,
             _stream(dev))
    LAUNCHES["gla"] += 1
    op_cost.charge("gla", *gla_cost(q, k, v, w, u, chunk))
    LAUNCHES[plan.key] += 1
    return o, s


def ssd_cuda(q: Tensor, k: Tensor, v: Tensor, a: Tensor, *,
             chunk: int = 32, form: Optional[str] = None
             ) -> Tuple[Tensor, Tensor]:
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
    _check_chunk("ssd", T, chunk)
    o = torch.empty_like(v)
    s = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    st = [(q.stride(0), 0, q.stride(1)), (k.stride(0), 0, k.stride(1)),
          _bht(v), _bht(a), _bht(o)]
    aligned = all(_rows_aligned(x, b) for x, b in
                  zip((q, k, v, o), (st[0], st[1], st[2], st[4])))
    plan = ssd_plan(B, H, T, N, P, chunk, aligned, form)
    lib = library()
    with torch.cuda.device(dev):
        _run(lib, lib.ssm_ssd_run, f"ssd ({plan.form})", FORMS[plan.form],
             plan.group, _P(q.data_ptr()), _P(k.data_ptr()),
             _P(v.data_ptr()), _P(a.data_ptr()), _P(o.data_ptr()),
             _P(s.data_ptr()), _strides(*st), B, H, T, N, P, chunk,
             _stream(dev))
    LAUNCHES["ssd"] += 1
    op_cost.charge("ssd", *ssd_cost(q, k, v, a, chunk))
    LAUNCHES[plan.key] += 1
    return o, s
