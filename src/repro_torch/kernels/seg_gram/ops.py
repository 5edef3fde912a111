"""Dispatch for the fused segment-Gram family, and the moment forms that
``repro_torch.core.moments`` routes to it under
``row_block_strategy="pallas"``.

There is one rule: a CUDA tensor goes to the Hopper kernel (kernel.py),
a CPU tensor to the plain version (ref.py).  No other lowering exists
and nothing falls back: a builder without a CUDA kernel raises on a CUDA
tensor.

Batching.  The "parallel" cross-fit engine writes the fold axis out as
a leading batch dimension: ``w`` may be (B, n), and a row-shaped input
may be (B, n, d) (gram_and_vec's per-fold ``wg`` and ``v``).  The result
then carries a leading B.  The kernel takes the batch in one launch;
the plain version loops over it.

The moments engine routes here only on its blocked path (row_block > 0);
the kernel's own row partition is fixed by its tile configuration
(csrc/seg_gram.cu), so no block size is passed.  Counts and n_eff are
plain sums outside the kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.seg_gram import kernel as _kernel
from repro_torch.kernels.seg_gram import ref as _ref

Tensor = torch.Tensor
_F32 = torch.float32

_LATER = {
    "build_residual_direct": "the bootstrap-inference slice",
    "build_fold_weighted": "the bootstrap-inference slice",
    "build_iv": "the IV slice",
    "build_iv_meat": "the IV slice",
    "build_pair": "the sweep/store slice",
}


def _col(x: Tensor) -> Tensor:
    """(n,) -> (n, 1); (B, n) -> (B, n, 1); fp32."""
    return x.to(_F32)[..., None]


def _vec(x: Tensor) -> Tensor:
    """(n, 1) -> (n,); (B, n, 1) -> (B, n), contiguous."""
    return x[..., 0].contiguous()


def _kernel_args(builder, arrays):
    """(kernel builder name, X, scalar columns, theta) for a CUDA launch."""
    if builder is _ref.build_design:
        (D,) = arrays
        return "design", D, (), None
    if builder is _ref.build_gram_and_vec:
        D, wg, v = arrays
        return "gram_and_vec", D, (_vec(wg), _vec(v)), None
    if builder is _ref.build_residual:
        *cols, phi = arrays
        return "residual", phi, tuple(_vec(c) for c in cols), None
    if builder is _ref.build_residual_meat:
        y, t, my, mt, phi, theta, *w = arrays
        cols = tuple(_vec(c) for c in [y, t, my, mt, *w])
        return "residual_meat", phi, cols, theta.reshape(-1).contiguous()
    name = getattr(builder, "__name__", repr(builder))
    later = _LATER.get(name, "a later slice")
    raise NotImplementedError(
        f"{name} has no CUDA kernel yet; it lands with {later}")


def seg_reduce(builder, arrays: Sequence[Tensor], *,
               seg: Optional[Tensor] = None, w: Optional[Tensor] = None,
               n_segments: int = 1) -> Tensor:
    """``G[s] = Σ_{seg_n = s} w_n L_n ⊗ R_n``: (qL, qR) for one segment,
    else (S, qL, qR), with a leading B when ``w`` or an input is
    batched."""
    arrays = [a.to(_F32) for a in arrays]
    dev = arrays[0].device
    w = None if w is None else w.to(_F32)
    batched = any(a.dim() == 3 for a in arrays) or (
        w is not None and w.dim() == 2)
    S = int(n_segments)
    if dev.type == "cuda":
        name, X, scalars, theta = _kernel_args(builder, arrays)
        if X.dim() != 2:
            raise ValueError("seg_gram: the row matrix must be shared, "
                             f"got shape {tuple(X.shape)}")
        G = _kernel.seg_gram_cuda(
            name, X.contiguous(), scalars=scalars, theta=theta,
            w=None if w is None else w.contiguous(),
            seg=None if S == 1 else seg.to(torch.int32).contiguous(),
            n_segments=S)
        qL, qR = G.shape[1] // S, G.shape[2]
        if S > 1:
            G = G.reshape(G.shape[0], S, qL, qR)
        return G if batched else G[0]
    if dev.type != "cpu":
        raise ValueError(f"seg_gram runs on cuda or cpu, not {dev}")

    def one(b):
        arrs = [a[b] if a.dim() == 3 else a for a in arrays]
        wb = None
        if w is not None:
            wb = (w[b] if w.dim() == 2 else w)[:, None]
        return _ref.seg_gram_plain(builder, arrs, seg=seg, w=wb,
                                   n_segments=S)

    if not batched:
        return one(None)
    B = max([a.shape[0] for a in arrays if a.dim() == 3]
            + ([w.shape[0]] if w is not None and w.dim() == 2 else []))
    return torch.stack([one(b) for b in range(B)])


def segment_counts(seg: Tensor, n_segments: int) -> Tensor:
    """Per-segment row counts as a plain compare-and-sum — deterministic
    on the card, and ids outside [0, S) count nowhere."""
    ids = torch.arange(n_segments, device=seg.device, dtype=seg.dtype)
    return (seg[:, None] == ids[None, :]).to(_F32).sum(0)


def design_gram(D: Tensor, *, w: Optional[Tensor] = None) -> Tensor:
    """(q, q) weighted Gram over a pre-assembled design ((B, q, q) for
    (B, n) weights)."""
    return seg_reduce(_ref.build_design, [D], w=w)


def fold_design_gram(D: Tensor, folds: Tensor,
                     k: int) -> Tuple[Tensor, Tensor]:
    """(k, q, q) fold-segmented Gram + per-fold counts."""
    G = seg_reduce(_ref.build_design, [D], seg=folds, n_segments=k)
    return G, segment_counts(folds, k)


def gram_and_vec(D: Tensor, wg: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ wg d dᵀ, Σ v d) in one pass, read off the augmented
    L = [wg·d | v]; wg, v (n,) or (B, n)."""
    q = D.shape[1]
    Gaug = seg_reduce(_ref.build_gram_and_vec, [D, _col(wg), _col(v)])
    return Gaug[..., :q, :], Gaug[..., q, :]


def residual_gram(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                  phi: Tensor, *,
                  w: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(G (p, p), b (p,)) of the orthogonal moment, read off the fused
    augmented Gram M = [rt*phi | ry]."""
    p = phi.shape[1]
    Gaug = seg_reduce(_ref.build_residual,
                      [_col(y), _col(t), _col(my), _col(mt), phi], w=w)
    return Gaug[:p, :p], Gaug[:p, p]


def residual_meat(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                  phi: Tensor, theta: Tensor, *,
                  w: Optional[Tensor] = None) -> Tensor:
    """(p, p) HC0 meat at theta; w scales e before squaring."""
    arrays = [_col(y), _col(t), _col(my), _col(mt), phi,
              theta.reshape(1, -1)]
    if w is not None:
        arrays.append(_col(w))
    return seg_reduce(_ref.build_residual_meat, arrays)
