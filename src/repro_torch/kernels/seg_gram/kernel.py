"""ctypes binding of the Hopper segmented-Gram kernel (csrc/seg_gram.cu).

Two entry points, both checking device, dtype, shape and contiguity,
launching on the current stream, and raising on anything they do not
take and whenever the launch returns a CUDA error — never falling back
to the plain version:

  ``seg_gram_cuda``  one segment: the raw columns of one of the seven
                     builders over fixed row splits, with a leading
                     batch; returns ``(B, qL, qR)`` fp32.
  ``seg_walk_cuda``  several segments (and ``pair``, the segmented outer
                     product of two row matrices): each block walks one
                     segment's own rows through a permutation
                     (``walk_plan``); returns ``(S, qL, qR)`` fp32, with
                     the leading batch when there is one.

``LAUNCHES`` counts launches per form (the builder's name,
``<name>_segmented`` for a walk of another builder, ``pair``, or the
``count_as`` key of an entry point of its own: ``residual_gram`` for
the final stage at row_block=0, ``fold_weighted`` for the bootstrap's
fold-and-replicate-weighted Grams), one per launch; ``SHAPES`` counts
the same launches by ``(form, S, qL, qR)``; ``PLANS`` counts the walk
plans made (``cached_walk_plan`` misses) by ``(S, rows per unit)``;
``LAUNCH_OBSERVERS`` are called after every launch with its (form, B, n,
S, qL, qR, input bytes): the task runtime counts a chunk's work there.

``design_of`` names the kernel a (qL, qR) output runs on (``"small"``,
``"thin"`` or ``"big"``); ``stage`` restricts the launches inside it to
the tile kernel or to the second pass, for timing them apart.

Replaces ``src/repro/kernels/seg_gram/kernel.py:seg_gram_pallas``; the
design and its bound on the H100 are in the source note of
``csrc/seg_gram.cu``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import weakref
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch import op_cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "seg_gram.cu"
BUILDERS = {"design": 0, "gram_and_vec": 1, "residual": 2,
            "residual_meat": 3, "residual_direct": 4, "iv": 5, "iv_meat": 6,
            "pair": 7}
# (scalar columns taken, copies of X, appended L columns, appended R
# columns) per builder: qL = copies * dX + appended
_LAYOUT = {"design": ((0,), 1, 0, 0), "gram_and_vec": ((2,), 1, 1, 0),
           "residual": ((4,), 1, 1, 1), "residual_meat": ((4, 5), 1, 0, 0),
           "residual_direct": ((2,), 1, 1, 1), "iv": ((3,), 2, 1, 1),
           "iv_meat": ((3, 4), 1, 0, 0), "pair": ((0,), 1, 0, 0)}
_MEATS = ("residual_meat", "iv_meat")
# the large-tile template's output tile (csrc/seg_gram.cu: BIG_T)
BIG_TILE = 128

LAUNCHES: collections.Counter = collections.Counter()
# Called after every launch as f(key, B, n, S, qL, qR, input_bytes): the
# task runtime's per-chunk cost count (repro_torch.runtime.memory).
LAUNCH_OBSERVERS: List = []
SHAPES: collections.Counter = collections.Counter()
PLANS: collections.Counter = collections.Counter()
# the parts of a launch that the C entry points run: 1 the tile kernel,
# 2 the second pass (``stage`` sets it for timing; every caller runs both)
_PARTS = {"all": 3, "main": 1, "reduce": 2}
_parts = _PARTS["all"]
_DESIGNS = ("small", "thin", "big")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def library() -> ctypes.CDLL:
    """The built kernel library (built from SOURCE on first call)."""
    lib, _ = build.load_library(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.seg_gram_split_rows.argtypes = [_I, _I]
        lib.seg_gram_split_rows.restype = _LL
        lib.seg_gram_config.argtypes = [_I, _I]
        lib.seg_gram_config.restype = _I
        lib.seg_gram_run.argtypes = [
            _I, _LL, _I, _P,             # builder, n, dX, X
            _P, _P, _P, _P, _P, _LL,     # a0..a4, a_bstride
            _P, _LL, _P, _LL,            # theta, its stride, w, w_bstride
            _I, _I, _I,                  # B, qL, qR
            _P, _I, _P, _P, _I,          # partial, P, out, stream, parts
        ]
        lib.seg_gram_run.restype = _I
        lib.seg_gram_walk.argtypes = [
            _I, _LL, _I, _P, _I, _P,     # builder, n, dX, X, dY, Y
            _P, _P, _P, _P, _P, _LL,     # a0..a4, a_bstride
            _P, _LL, _P, _LL,            # theta, its stride, w, w_bstride
            _P, _P, _P, _P, _P,          # perm, unit seg/lo/hi, first
            _I, _I, _I, _I, _I, _I,      # W, S, B, qL, qR, pair_sym
            _P, _P, _P, _P, _I,          # init, partial, out, stream, parts
        ]
        lib.seg_gram_walk.restype = _I
        lib.seg_gram_tile_schedule.argtypes = [_I, _I, _I, _P, _P, _I]
        lib.seg_gram_tile_schedule.restype = _I
        lib.seg_gram_error_string.argtypes = [_I]
        lib.seg_gram_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def design_of(qL: int, qR: int) -> str:
    """The kernel that a (qL, qR) output runs on: ``"small"`` (both
    widths <= 16), ``"thin"`` (pair, qL <= 8) or ``"big"`` (the large
    tile) — csrc/seg_gram.cu's ``config_of``."""
    return _DESIGNS[library().seg_gram_config(qL, qR)]


@contextlib.contextmanager
def stage(name: str):
    """Inside, every seg_gram launch runs only its tile kernel
    (``"main"``) or only its second pass (``"reduce"``, over a partial
    buffer it allocates), so that the two can be timed apart; its
    output is then not the Gram.  Not thread-safe: for timing only."""
    global _parts
    old, _parts = _parts, _PARTS[name]
    try:
        yield
    finally:
        _parts = old


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


def cost(B: int, n: int, S: int, qL: int, qR: int,
         input_bytes: float) -> Tuple[float, float]:
    """(flops, bytes) of one launch: a multiply-add per row per distinct
    Gram entry (a square Gram is symmetric: q(q+1)/2 entries), for each
    of B weight rows; the inputs read and the (B, S, qL, qR) fp32 Grams
    written once."""
    entries = qL * (qL + 1) / 2 if qL == qR else qL * qR
    return 2.0 * B * n * entries, input_bytes + 4.0 * B * S * qL * qR


def _observe(key, B, n, S, qL, qR, inputs) -> None:
    if LAUNCH_OBSERVERS or op_cost.counting():
        nbytes = sum(x.numel() * x.element_size() for x in inputs
                     if x is not None)
        for f in LAUNCH_OBSERVERS:
            f(key, B, n, S, qL, qR, nbytes)
        op_cost.charge("seg_gram", *cost(B, n, S, qL, qR, nbytes))


def _raise_on(lib, err: int, builder: str) -> None:
    if err != 0:
        msg = lib.seg_gram_error_string(err).decode()
        raise RuntimeError(f"seg_gram[{builder}] launch failed: {msg} ({err})")


def _widths(builder: str, X: torch.Tensor, scalars, Y) -> tuple:
    counts, copies, dl, dr = _LAYOUT[builder]
    if len(scalars) not in counts:
        raise ValueError(f"seg_gram[{builder}] takes {counts} scalar columns, "
                         f"got {len(scalars)}")
    dX = X.shape[1]
    if builder == "pair":
        if Y is None:
            raise ValueError("seg_gram[pair] needs Y")
        return dX, Y.shape[1]
    if Y is not None:
        raise ValueError(f"seg_gram[{builder}] takes no Y")
    return copies * dX + dl, copies * dX + dr


def _check_theta(builder, theta, dev, dX, B) -> int:
    """Checks theta; returns its batch stride."""
    if builder in _MEATS:
        if theta is None:
            raise ValueError(f"seg_gram[{builder}] needs theta")
        _check("theta", theta, dev, torch.float32, [(dX,), (B, dX)])
        return dX if theta.dim() == 2 else 0
    if theta is not None:
        raise ValueError(f"seg_gram[{builder}] takes no theta")
    return 0


def _batch_args(builder, n, dX, scalars, theta, w, dev):
    """(B, scalar stride, theta stride, w stride) of the per-row columns,
    all (n,) or (B, n), theta (dX,) or (B, dX)."""
    f32 = torch.float32
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
    th_b = _check_theta(builder, theta, dev, dX, B)
    w_b = 0
    if w is not None:
        _check("w", w, dev, f32, [(n,), (B, n)])
        w_b = n if w.dim() == 2 else 0
    return B, a_b, th_b, w_b


def launch_key(builder: str, *, walk: bool,
               count_as: Optional[str] = None) -> str:
    """The ``LAUNCHES`` key of one launch of ``builder``: ``count_as``
    when the caller names one, else the form — the builder's name for
    one segment and for the pair walk, ``<builder>_segmented`` for any
    other segment walk."""
    if count_as:
        return count_as
    return builder if not walk or builder == "pair" else f"{builder}_segmented"


def seg_gram_cuda(builder: str, X: torch.Tensor, *,
                  scalars: Sequence[torch.Tensor] = (),
                  theta: Optional[torch.Tensor] = None,
                  w: Optional[torch.Tensor] = None,
                  count_as: Optional[str] = None) -> torch.Tensor:
    """One segment.  ``X`` (n, dX) is the row matrix (the design D or
    phi); ``scalars`` the builder's per-row columns, all (n,) or all
    (B, n) — gram_and_vec: (wg, v); residual: (y, t, my, mt);
    residual_direct: (ry, rt); residual_meat: (y, t, my, mt[, w]); iv:
    (ry, rt, rz); iv_meat: (ry, rt, rz[, w]).  ``theta`` (dX,) or
    (B, dX) for the meats; ``w`` (n,) or (B, n) row weights.
    ``count_as`` names the ``LAUNCHES`` key of a caller that is an entry
    point of its own (default: the form).  Returns (B, qL, qR) fp32;
    raises naming the shape if the split-partial buffer does not fit."""
    if builder not in BUILDERS or builder == "pair":
        raise NotImplementedError(f"seg_gram has no one-segment CUDA "
                                  f"builder {builder!r}")
    if X.device.type != "cuda":
        raise ValueError(f"seg_gram_cuda needs CUDA tensors, X is on {X.device}")
    if X.dim() != 2:
        raise ValueError(f"seg_gram: X must be (n, d), got {tuple(X.shape)}")
    dev, f32 = X.device, torch.float32
    n, dX = X.shape
    _check("X", X, dev, f32, [(n, dX)])
    qL, qR = _widths(builder, X, scalars, None)
    B, a_b, th_b, w_b = _batch_args(builder, n, dX, scalars, theta, w, dev)

    lib = library()
    rs = lib.seg_gram_split_rows(qL, qR)
    P = max(1, -(-n // rs))
    shape = (P, B, qL, qR)
    try:
        partial = torch.empty(shape, dtype=f32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"seg_gram[{builder}]: the split-partial buffer {shape} "
            f"({4 * P * B * qL * qR / 2 ** 30:.2f} GiB) does not fit on "
            f"{dev}; take fewer replicates per chunk (runtime_chunk)") from e
    out = torch.empty((B, qL, qR), dtype=f32, device=dev)
    a = list(scalars) + [None] * (5 - len(scalars))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_gram_run(
            BUILDERS[builder], n, dX, _ptr(X),
            *[_ptr(x) for x in a], a_b,
            _ptr(theta), th_b, _ptr(w), w_b,
            B, qL, qR, _ptr(partial), P, _ptr(out), _P(stream), _parts)
    _raise_on(lib, err, builder)
    key = launch_key(builder, walk=False, count_as=count_as)
    LAUNCHES[key] += 1
    SHAPES[(key, 1, qL, qR)] += 1
    _observe(key, B, n, 1, qL, qR, (X, *scalars, theta, w))
    return out


def tile_schedule(qL: int, qR: int, symmetric: bool,
                  tile: int = BIG_TILE) -> List[Tuple[int, int]]:
    """The (tile row, tile col) output tiles that the large-tile template
    launches for a (qL, qR) output, in launch order; ``tiles_big`` and
    ``tile_of`` in csrc/seg_gram.cu mirror it (the library's
    ``seg_gram_tile_schedule`` lists theirs, which a card test holds
    equal to this).  Full: every tile, row by
    row.  Symmetric (every builder but pair, and pair of one tensor with
    itself): the upper triangle, tile row <= tile col, row by row — the
    kernel mirrors it — and, when qL > qR (gram_and_vec's appended row
    qR), the tiles left of the diagonal in that row's tile row, so that
    the row is computed in full."""
    TR = -(-qR // tile)
    if not symmetric:
        return [(i, j) for i in range(-(-qL // tile)) for j in range(TR)]
    out = [(i, j) for i in range(TR) for j in range(i, TR)]
    if qL > qR:
        out += [(qR // tile, j) for j in range(qR // tile)]
    return out


# Tensors that a symmetric pair walk returned (one triangle and its
# mirror: bitwise symmetric), by id: (weak reference, version counter).
# Seeded with one of them, unchanged since (an in-place write bumps the
# counter), a launch skips init's symmetry check — so the store's
# accumulators are read for it on their first ingest and after a
# restore, not on every day's.
_SYMMETRIC: dict = {}


def _known_symmetric(t: torch.Tensor) -> bool:
    ent = _SYMMETRIC.get(id(t))
    return ent is not None and ent[0]() is t and ent[1] == t._version


def _mark_symmetric(t: torch.Tensor) -> None:
    key = id(t)
    _SYMMETRIC[key] = (weakref.ref(t, lambda _: _SYMMETRIC.pop(key, None)),
                       t._version)


def _same_rows(X: torch.Tensor, Y: Optional[torch.Tensor],
               init: Optional[torch.Tensor]) -> bool:
    """pair's V is its U (one tensor: same storage, shape and strides),
    so its Gram is symmetric — and, seeded, init is symmetric too: the
    kernel then computes one triangle and mirrors it."""
    if Y is None or Y.data_ptr() != X.data_ptr() or Y.shape != X.shape \
            or Y.stride() != X.stride():
        return False
    return init is None or _known_symmetric(init) or torch.equal(
        init, init.transpose(-1, -2))


class WalkPlan(NamedTuple):
    """The unit table of a segment walk.  ``perm`` lists the row ids
    sorted by segment (stable; ids outside [0, S) at the end, never
    read); unit u covers ``perm[lo[u]:hi[u]]`` of segment ``useg[u]``
    (``S`` for the unused tail of the table); segment s owns units
    ``first[s] .. first[s+1]-1``, at least one."""

    perm: torch.Tensor      # (n,) int64
    useg: torch.Tensor      # (W,) int32
    lo: torch.Tensor        # (W,) int64
    hi: torch.Tensor        # (W,) int64
    first: torch.Tensor     # (S+1,) int32


def walk_plan(seg: torch.Tensor, n_segments: int,
              rows_per_unit: Optional[int]) -> WalkPlan:
    """Sort the rows by segment and cut each segment into units of at
    most ``rows_per_unit`` rows (``None``: one unit per segment).  Exact
    integer work on the rows' device, with no synchronisation: the table
    has ``ceil(n / rows_per_unit) + S`` entries (``S`` unsplit), enough
    for any segment sizes, and the kernel skips the unused tail."""
    S, n, dev = int(n_segments), seg.shape[0], seg.device
    seg = seg.long()
    key = torch.where((seg >= 0) & (seg < S), seg, torch.full_like(seg, S))
    skey, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(skey, torch.arange(S + 1, device=dev))
    lens = bounds[1:] - bounds[:-1]
    if rows_per_unit is None:
        nsplit, W, rs = torch.ones_like(lens), S, None
    else:
        rs = int(rows_per_unit)
        nsplit = torch.clamp((lens + rs - 1) // rs, min=1)
        W = -(-n // rs) + S
    first = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       torch.cumsum(nsplit, 0)])
    u = torch.arange(W, device=dev)
    useg = torch.searchsorted(first[1:], u, right=True)
    s = useg.clamp(max=S - 1)
    if rs is None:
        lo, hi = bounds[s], bounds[s + 1]
    else:
        lo = bounds[s] + (u - first[s]) * rs
        hi = torch.minimum(lo + rs, bounds[s + 1])
    return WalkPlan(perm.contiguous(), useg.to(torch.int32).contiguous(),
                    lo.contiguous(), hi.contiguous(),
                    first.to(torch.int32).contiguous())


# Walk plans by (id(seg), S, rows per unit): (weak reference to seg, its
# version counter, plan), least recently used first.  The sweep walks
# the same two id tensors in every MM step; an in-place write to seg
# bumps its counter and makes a new plan; a dropped seg drops its plans.
_PLAN_CACHE: "collections.OrderedDict" = collections.OrderedDict()
PLAN_CACHE_SIZE = 8


def cached_walk_plan(seg: torch.Tensor, n_segments: int,
                     rows_per_unit: Optional[int]) -> WalkPlan:
    """``walk_plan(seg, n_segments, rows_per_unit)``, made once per id
    tensor (and version, S, rows per unit) and kept for the last
    ``PLAN_CACHE_SIZE`` of them; on any device."""
    S = int(n_segments)
    rs = None if rows_per_unit is None else int(rows_per_unit)
    key = (id(seg), S, rs)
    ent = _PLAN_CACHE.get(key)
    if ent is not None and ent[0]() is seg and ent[1] == seg._version:
        _PLAN_CACHE.move_to_end(key)
        return ent[2]
    plan = walk_plan(seg, S, rs)
    PLANS[(S, rs)] += 1
    _PLAN_CACHE[key] = (weakref.ref(seg, lambda _: _PLAN_CACHE.pop(key, None)),
                        seg._version, plan)
    _PLAN_CACHE.move_to_end(key)
    while len(_PLAN_CACHE) > PLAN_CACHE_SIZE:
        _PLAN_CACHE.popitem(last=False)
    return plan


def clear_plan_cache() -> None:
    """Forget every cached walk plan (the next walk of each id tensor
    plans again)."""
    _PLAN_CACHE.clear()


def seg_walk_cuda(builder: str, X: torch.Tensor, *,
                  Y: Optional[torch.Tensor] = None,
                  scalars: Sequence[torch.Tensor] = (),
                  theta: Optional[torch.Tensor] = None,
                  w: Optional[torch.Tensor] = None,
                  seg: torch.Tensor, n_segments: int,
                  init: Optional[torch.Tensor] = None,
                  count_as: Optional[str] = None) -> torch.Tensor:
    """``G[s] = Σ_{seg_n = s} w_n L_n ⊗ R_n`` by the segment walk:
    (S, qL, qR) fp32, with a leading B when a scalar column, ``w`` or
    ``theta`` is batched.  ``builder`` and its columns as
    ``seg_gram_cuda``, or ``"pair"`` with ``X`` = U (n, qU) and ``Y`` = V
    (n, qV).  ``seg`` (n,) integer ids; ids outside [0, S) count
    nowhere.  ``init`` (S, qL, qR) — or (B, S, qL, qR) — seeds the
    accumulators of an unsplit walk (one unit per segment; it is read,
    never written); without it, segments longer than the tile
    configuration's rows per unit are split and their units summed in
    order by a second pass.  ``Y`` the very tensor ``X`` (and ``init``
    symmetric) makes pair's Gram symmetric: the large tile then computes
    one triangle and mirrors it, as it does for every other builder.
    init's symmetry is read from it (a full pass), unless init is a
    symmetric walk's own result, unchanged since."""
    if builder not in BUILDERS:
        raise NotImplementedError(f"seg_gram has no CUDA builder {builder!r}")
    if X.device.type != "cuda":
        raise ValueError(f"seg_walk_cuda needs CUDA tensors, X is on {X.device}")
    if X.dim() != 2:
        raise ValueError(f"seg_gram: X must be (n, d), got {tuple(X.shape)}")
    dev, f32 = X.device, torch.float32
    n, dX = X.shape
    _check("X", X, dev, f32, [(n, dX)])
    if Y is not None:
        _check("Y", Y, dev, f32, [(n, Y.shape[-1])])
    qL, qR = _widths(builder, X, scalars, Y)
    B, a_b, th_b, w_b = _batch_args(builder, n, dX, scalars, theta, w, dev)
    batched = any(x is not None and x.dim() == 2
                  for x in list(scalars) + [w, theta])
    S = int(n_segments)
    if S < 1:
        raise ValueError(f"n_segments must be >= 1, got {S}")
    if seg.device != dev or seg.dim() != 1 or seg.shape[0] != n:
        raise ValueError(f"seg_gram: seg must be ({n},) on {dev}, got "
                         f"{tuple(seg.shape)} on {seg.device}")
    if init is not None:
        _check("init", init, dev, f32,
               [(B, S, qL, qR)] if batched else [(S, qL, qR)])

    same = builder == "pair" and _same_rows(X, Y, init)
    lib = library()
    rs = None if init is not None else lib.seg_gram_split_rows(qL, qR)
    plan = cached_walk_plan(seg, S, rs)
    W = plan.useg.shape[0]
    out = torch.empty((B, S, qL, qR), dtype=f32, device=dev)
    partial = None if init is not None else torch.empty(
        (W, B, qL, qR), dtype=f32, device=dev)
    a = list(scalars) + [None] * (5 - len(scalars))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_gram_walk(
            BUILDERS[builder], n, dX, _ptr(X),
            0 if Y is None else Y.shape[1], _ptr(Y),
            *[_ptr(x) for x in a], a_b, _ptr(theta), th_b, _ptr(w), w_b,
            *[_ptr(x) for x in plan],
            W, S, B, qL, qR, int(same), _ptr(init), _ptr(partial),
            _ptr(out), _P(stream), _parts)
    _raise_on(lib, err, builder)
    key = launch_key(builder, walk=True, count_as=count_as)
    LAUNCHES[key] += 1
    SHAPES[(key, S, qL, qR)] += 1
    _observe(key, B, n, S, qL, qR, (X, Y, *scalars, theta, w, seg, init))
    out = out if batched else out[0]
    if same:
        _mark_symmetric(out)
    return out
