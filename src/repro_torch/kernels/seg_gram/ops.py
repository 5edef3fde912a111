"""Dispatch for the fused segment-Gram family, and the moment forms that
``repro_torch.core.moments`` routes to it under
``row_block_strategy="pallas"``.

There is one rule: a CUDA tensor goes to the Hopper kernel (kernel.py),
a CPU tensor to the plain version (ref.py).  No other lowering exists
and nothing falls back: a builder without a CUDA kernel raises on a CUDA
tensor.

Batching.  The "parallel" cross-fit engine writes the fold axis out as
a leading batch dimension, and the bootstrap the replicate axis (or
replicates times folds): ``w`` may be (B, n), a row-shaped input
(B, n, d) and a broadcast row such as theta (B, 1, d).  The result then
carries a leading B.  The kernel takes the batch in one launch; the
plain version loops over it.  ``build_fold_weighted`` carries its batch
in the dense weights ``Wt`` (n, k) instead and returns the reference's
(k·q, q) layout: on the card it is the design kernel with ``Wt.T`` as a
batched row weight, on the CPU each fold's block of the kron builder in
turn — neither forms the (n, k·q) operand.

Segments.  With S > 1 (and always for ``build_pair``, the segmented
outer product of two row matrices) the card runs the segment walk: each
block reads one segment's own rows through a permutation, so no launch
multiplies the zeros of a one-hot expansion; the batch rides along as
in the one-segment form.  ``init`` (S, qL, qR) seeds the result: the
CPU adds it to the
plain Gram (the reference kernel's delta-add), the card starts an
unsplit walk from it — bitwise the one-shot pass over the concatenated
rows of two ingests.

The moments engine routes here only on its blocked path (row_block > 0);
the kernel's own row partition is fixed by its tile configuration
(csrc/seg_gram.cu), so ``row_block`` sets no tile.  It matters under a
data mesh only (``runtime.distributed``): with a mesh active and
0 < row_block < n, each block of row_block rows is one ``seg_reduce`` —
one kernel launch on the card, the plain version on the CPU — on the
rank that owns it, and ``dist_reduce`` folds the partials in block
order, from ``init``, which no block launch sees.  Padded rows carry
w = 0, zero columns or segment id -1, which add exact zeros.  Counts and
n_eff are plain sums outside the kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.seg_gram import kernel as _kernel
from repro_torch.kernels.seg_gram import ref as _ref

Tensor = torch.Tensor
_F32 = torch.float32

def _col(x: Tensor) -> Tensor:
    """(n,) -> (n, 1); (B, n) -> (B, n, 1); fp32."""
    return x.to(_F32)[..., None]


def _as_rows(x: Tensor) -> Tensor:
    """(n,) -> (n, 1); (n, q) stays; fp32."""
    x = x.to(_F32)
    return x[:, None] if x.dim() == 1 else x


def _vec(x: Tensor) -> Tensor:
    """(n, 1) -> (n,); (B, n, 1) -> (B, n), contiguous."""
    return x[..., 0].contiguous()


def _theta(theta: Tensor) -> Tensor:
    """(1, d) -> (d,); (B, 1, d) -> (B, d), contiguous."""
    return theta.reshape(theta.shape[:-2] + theta.shape[-1:]).contiguous()


def _row(theta: Tensor) -> Tensor:
    """(p,) -> (1, p); (B, p) -> (B, 1, p): a broadcast builder row."""
    return theta.to(_F32).unsqueeze(-2)


# builders whose inputs are per-row columns, then phi
_COLUMNS = {_ref.build_residual: "residual",
            _ref.build_residual_direct: "residual_direct",
            _ref.build_iv: "iv"}
# the meats: (name, columns before phi); then phi, theta[, builder w]
_MEATS = {_ref.build_residual_meat: ("residual_meat", 4),
          _ref.build_iv_meat: ("iv_meat", 3)}


def _active_data_mesh():
    """The active DataMesh (the sys.modules probe of core.moments: no
    runtime-layer import unless a mesh can be active)."""
    import sys
    rd = sys.modules.get("repro_torch.runtime.distributed")
    return None if rd is None else rd.current_data_mesh()


def _seg_reduce_dist(builder, arrays, seg, w, n_segments, init, row_block,
                     dm):
    """``seg_reduce`` per block of ``row_block`` rows over the mesh's
    ranks.  Row inputs go to the distributed fold rows first — (n, d)
    as they are, a batched (B, n, d) input and (B, n) weights transposed
    — and come back to their own layout inside each block; broadcast
    rows (theta's (1, d) or (B, 1, d)) reach every block whole."""
    from repro_torch.runtime.distributed import dist_reduce

    n = max(a.shape[-2] for a in arrays)
    rows, pads, kinds = [], [], []
    for a in arrays:
        if a.shape[-2] != n:
            kinds.append(a)                      # broadcast: passed whole
            continue
        kinds.append(a.dim())
        rows.append(a if a.dim() == 2 else a.transpose(0, 1))
        pads.append(0)
    if seg is not None:
        rows.append(seg)
        pads.append(-1)
    if w is not None:
        rows.append(w if w.dim() == 1 else w.T)
        pads.append(0)

    def block(*blks):
        it = iter(blks)
        arrs = [k if isinstance(k, Tensor) else
                (next(it) if k == 2 else next(it).transpose(0, 1))
                for k in kinds]
        sb = next(it) if seg is not None else None
        wb = None
        if w is not None:
            wb = next(it)
            wb = wb if w.dim() == 1 else wb.T
        return seg_reduce(builder, arrs, seg=sb, w=wb,
                          n_segments=n_segments)

    return dist_reduce(block, rows, row_block=row_block, dm=dm,
                       pad_values=pads,
                       init=None if init is None else init.to(_F32))


def _kernel_args(builder, arrays, w=None):
    """(kernel builder name, X, scalar columns, theta, row weights,
    LAUNCHES key or None) for a CUDA launch."""
    if builder is _ref.build_design:
        (D,) = arrays
        return "design", D, (), None, w, None
    if builder is _ref.build_fold_weighted:
        Wt, D = arrays
        if w is not None:
            raise ValueError("build_fold_weighted carries its weights in Wt")
        return "design", D, (), None, Wt.T.contiguous(), "fold_weighted"
    if builder is _ref.build_gram_and_vec:
        D, wg, v = arrays
        return "gram_and_vec", D, (_vec(wg), _vec(v)), None, w, None
    if builder in _COLUMNS:
        *cols, phi = arrays
        return (_COLUMNS[builder], phi, tuple(_vec(c) for c in cols), None,
                w, None)
    if builder in _MEATS:
        name, nc = _MEATS[builder]
        cols = [*arrays[:nc], *arrays[nc + 2:]]     # [, builder w] last
        return (name, arrays[nc], tuple(_vec(c) for c in cols),
                _theta(arrays[nc + 1]), w, None)
    if builder is _ref.build_pair:
        return "pair", arrays[0], (), None, w, None
    name = getattr(builder, "__name__", repr(builder))
    raise NotImplementedError(f"{name} has no CUDA kernel")


def _walks(builder, n_segments: int, init: Optional[Tensor]) -> bool:
    """Whether a call runs the segment walk (module docstring)."""
    return (int(n_segments) > 1 or builder is _ref.build_pair
            or init is not None)


def launch_key(builder, arrays: Sequence[Tensor], *,
               w: Optional[Tensor] = None, n_segments: int = 1,
               init: Optional[Tensor] = None) -> str:
    """The ``kernel.LAUNCHES`` key under which ``seg_reduce`` of these
    arguments counts its launch on the card (on any device: it reads
    only the builder and the shapes' roles)."""
    name, *_, count = _kernel_args(builder, arrays, w)
    walk = _walks(builder, n_segments, init)
    return _kernel.launch_key(name, walk=walk,
                              count_as=None if walk else count)


def seg_reduce_plain(builder, arrays: Sequence[Tensor], *,
                     seg: Optional[Tensor] = None,
                     w: Optional[Tensor] = None, n_segments: int = 1,
                     init: Optional[Tensor] = None) -> Tensor:
    """``seg_reduce``'s plain version, in the inputs' own dtype, on their
    device: what a CPU call computes (there in fp32)."""
    walk = _walks(builder, n_segments, init)
    if builder is _ref.build_fold_weighted:
        Wt, D = arrays
        return torch.cat([_ref.seg_gram_plain(builder, [Wt[:, j:j + 1], D])
                          for j in range(Wt.shape[1])])
    batched = any(a.dim() == 3 for a in arrays) or (
        w is not None and w.dim() == 2)

    def one(b):
        arrs = [a[b] if a.dim() == 3 else a for a in arrays]
        wb = None
        if w is not None:
            wb = (w[b] if w.dim() == 2 else w)[:, None]
        return _ref.seg_gram_plain(builder, arrs, seg=seg if walk else None,
                                   w=wb, n_segments=int(n_segments))

    if not batched:
        G = one(None)
    else:
        B = max([a.shape[0] for a in arrays if a.dim() == 3]
                + ([w.shape[0]] if w is not None and w.dim() == 2 else []))
        G = torch.stack([one(b) for b in range(B)])
    return G if init is None else init.to(G.dtype) + G


def seg_reduce(builder, arrays: Sequence[Tensor], *,
               seg: Optional[Tensor] = None, w: Optional[Tensor] = None,
               n_segments: int = 1, init: Optional[Tensor] = None,
               row_block: int = 0) -> Tensor:
    """``G[s] = Σ_{seg_n = s} w_n L_n ⊗ R_n``: (qL, qR) for one segment,
    else (S, qL, qR), with a leading B when ``w`` or an input is
    batched; ``init`` seeds it.  ``row_block``: the mesh's block size
    (module docstring)."""
    arrays = [a.to(_F32) for a in arrays]
    if row_block > 0:
        dm = _active_data_mesh()
        if dm is not None and row_block < max(a.shape[-2] for a in arrays):
            return _seg_reduce_dist(builder, arrays, seg,
                                    None if w is None else w.to(_F32),
                                    n_segments, init, int(row_block), dm)
    dev = arrays[0].device
    w = None if w is None else w.to(_F32)
    if builder is _ref.build_fold_weighted and (w is not None
                                                or n_segments != 1):
        raise ValueError("build_fold_weighted takes no row weights or "
                         "segments: its weights are Wt")
    batched = any(a.dim() == 3 for a in arrays) or (
        w is not None and w.dim() == 2)
    S = int(n_segments)
    walk = _walks(builder, S, init)
    if walk and seg is None:
        raise ValueError("seg_gram: a segmented call needs seg")
    if dev.type == "cuda":
        name, X, scalars, theta, wk, count = _kernel_args(builder, arrays,
                                                          w)
        if X.dim() != 2:
            raise ValueError("seg_gram: the row matrix must be shared, "
                             f"got shape {tuple(X.shape)}")
        if walk:
            Y = arrays[1].contiguous() if name == "pair" else None
            return _kernel.seg_walk_cuda(
                name, X.contiguous(), Y=Y, scalars=scalars,
                theta=None if theta is None else theta.contiguous(),
                w=None if wk is None else wk.contiguous(), seg=seg,
                n_segments=S,
                init=None if init is None else init.to(_F32).contiguous())
        G = _kernel.seg_gram_cuda(
            name, X.contiguous(), scalars=scalars, theta=theta,
            w=None if wk is None else wk.contiguous(), count_as=count)
        if builder is _ref.build_fold_weighted:
            return G.reshape(-1, G.shape[2])
        return G if batched else G[0]
    if dev.type != "cpu":
        raise ValueError(f"seg_gram runs on cuda or cpu, not {dev}")
    return seg_reduce_plain(builder, arrays, seg=seg, w=w, n_segments=S,
                            init=init)


def segment_counts(seg: Tensor, n_segments: int) -> Tensor:
    """Per-segment row counts (fp32): exact integer counts, so they do
    not depend on the order they are taken in; ids outside [0, S) count
    nowhere."""
    seg = seg.long()
    ok = (seg >= 0) & (seg < n_segments)
    ids = torch.where(ok, seg, torch.full_like(seg, n_segments))
    return torch.bincount(ids, minlength=n_segments + 1)[:n_segments].to(_F32)


def design_gram(D: Tensor, *, w: Optional[Tensor] = None,
                row_block: int = 0) -> Tensor:
    """(q, q) weighted Gram over a pre-assembled design ((B, q, q) for
    (B, n) weights)."""
    return seg_reduce(_ref.build_design, [D], w=w, row_block=row_block)


def fold_design_gram(D: Tensor, folds: Tensor, k: int, *,
                     row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """(k, q, q) fold-segmented Gram + per-fold counts."""
    G = seg_reduce(_ref.build_design, [D], seg=folds, n_segments=k,
                   row_block=row_block)
    return G, segment_counts(folds, k)


def gram_and_vec(D: Tensor, wg: Tensor, v: Tensor, *,
                 row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """(Σ wg d dᵀ, Σ v d) in one pass, read off the augmented
    L = [wg·d | v]; wg, v (n,) or (B, n)."""
    q = D.shape[1]
    Gaug = seg_reduce(_ref.build_gram_and_vec, [D, _col(wg), _col(v)],
                      row_block=row_block)
    return Gaug[..., :q, :], Gaug[..., q, :]


def residual_gram(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                  phi: Tensor, *, w: Optional[Tensor] = None,
                  row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """(G (p, p), b (p,)) of the orthogonal moment, read off the fused
    augmented Gram M = [rt*phi | ry]."""
    p = phi.shape[1]
    Gaug = seg_reduce(_ref.build_residual,
                      [_col(y), _col(t), _col(my), _col(mt), phi], w=w,
                      row_block=row_block)
    return Gaug[:p, :p], Gaug[:p, p]


def residual_meat(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                  phi: Tensor, theta: Tensor, *,
                  w: Optional[Tensor] = None, row_block: int = 0) -> Tensor:
    """(p, p) HC0 meat at theta; w scales e before squaring.  Batched:
    y, t, my, mt, w (B, n) and theta (B, p) -> (B, p, p)."""
    arrays = [_col(y), _col(t), _col(my), _col(mt), phi, _row(theta)]
    if w is not None:
        arrays.append(_col(w))
    return seg_reduce(_ref.build_residual_meat, arrays, row_block=row_block)


def fold_weighted_design_gram(D: Tensor, Wk: Tensor, *,
                              row_block: int = 0) -> Tensor:
    """(k, q, q) dense-weight Gram ``G[k] = Σ_n Wk[k, n] d_n d_nᵀ`` for
    Wk (k, n) — k any batch of folds (times replicates).  One launch of
    the design kernel with Wk as a batched row weight, counted as
    ``fold_weighted``; n_eff stays outside (moments.fold_weighted_gram)."""
    k, q = Wk.shape[0], D.shape[1]
    G = seg_reduce(_ref.build_fold_weighted, [Wk.T, D], row_block=row_block)
    return G.reshape(k, q, q)


def residual_weighted_gram(ry: Tensor, rt: Tensor, phi: Tensor, w: Tensor,
                           *, row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """(weighted augmented residual Gram over M = [rt·phi | ry], n_eff):
    ((p+1, p+1), ()) or, for ry, rt, w (B, n), ((B, p+1, p+1), (B,))."""
    Gaug = seg_reduce(_ref.build_residual_direct,
                      [_col(ry), _col(rt), phi], w=w, row_block=row_block)
    return Gaug, w.to(_F32).sum(-1)


def iv_gram(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor, w: Tensor, *,
            row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """((2p+1, 2p+1) instrumented augmented Gram over
    M = [rz·phi | rt·phi | ry], n_eff); batched as residual_weighted_gram."""
    Gaug = seg_reduce(_ref.build_iv, [_col(ry), _col(rt), _col(rz), phi],
                      w=w, row_block=row_block)
    return Gaug, w.to(_F32).sum(-1)


def fold_iv_gram(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor,
                 folds: Tensor, k: int, *,
                 row_block: int = 0) -> Tuple[Tensor, Tensor]:
    """((k, 2p+1, 2p+1) fold-segmented instrumented Gram, counts)."""
    G = seg_reduce(_ref.build_iv, [_col(ry), _col(rt), _col(rz), phi],
                   seg=folds, n_segments=k, row_block=row_block)
    return G, segment_counts(folds, k)


def iv_meat(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor,
            theta: Tensor, *, w: Optional[Tensor] = None,
            row_block: int = 0) -> Tensor:
    """(p, p) HC0 meat of the instrumented moment at theta (batched as
    residual_meat)."""
    arrays = [_col(ry), _col(rt), _col(rz), phi, _row(theta)]
    if w is not None:
        arrays.append(_col(w))
    return seg_reduce(_ref.build_iv_meat, arrays, row_block=row_block)


def segment_outer(U: Tensor, V: Tensor, seg: Tensor, n_segments: int, *,
                  w: Optional[Tensor] = None, init: Optional[Tensor] = None,
                  row_block: int = 0) -> Tensor:
    """(S, qU, qV) segmented outer-product sums ``Σ_{seg_n = s} w_n U_n
    ⊗ V_n`` — the sweep's MM gradient terms and per-segment final stage,
    the store's accumulators.  U, V (n, q) or (n,); ``init`` (S, qU, qV)
    seeds the sum; ``row_block``: the mesh's block size (see
    ``seg_reduce``: without a mesh it changes nothing)."""
    return seg_reduce(_ref.build_pair, [_as_rows(U), _as_rows(V)], seg=seg, w=w,
                      n_segments=n_segments, init=init, row_block=row_block)
