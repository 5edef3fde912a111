"""Builders + the plain PyTorch segmented Gram.

Every Gram-shaped moment in ``repro_torch.core.moments`` is one shape:

    G[s] = sum_{n: seg_n = s}  w_n * L_n (x) R_n

where the per-row factors (L, R) come from a *builder* over the raw
row-shaped ``(rows, d)`` or broadcast ``(1, d)`` inputs.  Builders are
row-linear and map all-zero input rows to all-zero L/R rows, which is
what makes zero-padding a row tail an exact no-op.

``seg_gram_plain`` is the plain version of the CUDA kernel
(kernel.py): the wrapper takes it for tensors on the CPU, and the card
check compares the kernel against it.  With one segment it is
``(L·w)ᵀR``; with segments, a loop over them of the product of each
segment's gathered rows — never the one-hot einsum, whose (n, S, qL)
temporary is gigabytes at a million rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]


def build_pair(U: Tensor, V: Tensor) -> Pair:
    """Plain segmented outer product: L = U, R = V."""
    return U, V


def build_design(D: Tensor) -> Pair:
    """Symmetric Gram over a pre-assembled design ``[X | 1? | y?]``."""
    return D, D


def build_residual(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                   phi: Tensor) -> Pair:
    """DML final stage: M = [(t - mt) * phi | (y - my)], G = MᵀM."""
    ry = y - my
    rt = t - mt
    M = torch.cat([rt * phi, ry], dim=1)
    return M, M


def build_residual_direct(ry: Tensor, rt: Tensor, phi: Tensor) -> Pair:
    """Residuals already formed: M = [rt*phi | ry]."""
    M = torch.cat([rt * phi, ry], dim=1)
    return M, M


def build_iv(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor) -> Pair:
    """Instrumented augmented Gram: M = [rz*phi | rt*phi | ry]."""
    M = torch.cat([rz * phi, rt * phi, ry], dim=1)
    return M, M


def build_fold_weighted(Wt: Tensor, D: Tensor) -> Pair:
    """Dense per-fold weights: L_n = Wt_n ⊗ d_n, R_n = d_n."""
    r = Wt.shape[0]
    L = (Wt[:, :, None] * D[:, None, :]).reshape(r, Wt.shape[1] * D.shape[1])
    return L, D


def build_gram_and_vec(D: Tensor, wg: Tensor, v: Tensor) -> Pair:
    """Two-weight Gram + cross-moment: L = [wg·d | v], R = d."""
    return torch.cat([wg * D, v], dim=1), D


def build_residual_meat(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                        phi: Tensor, theta: Tensor,
                        w: Optional[Tensor] = None) -> Pair:
    """HC0 meat of the orthogonal moment: m = (w *) e * z with
    z = rt*phi, e = ry - <z, theta> (theta a (1, p) broadcast row)."""
    ry = y - my
    rt = t - mt
    z = rt * phi
    e = ry - torch.sum(z * theta, dim=1, keepdim=True)
    if w is not None:
        e = w * e
    m = e * z
    return m, m


def build_iv_meat(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor,
                  theta: Tensor, w: Optional[Tensor] = None) -> Pair:
    """HC0 meat of the instrumented moment: score rz*phi, residual
    e = ry - <rt*phi, theta>."""
    z = rt * phi
    e = ry - torch.sum(z * theta, dim=1, keepdim=True)
    if w is not None:
        e = w * e
    m = e * (rz * phi)
    return m, m


def seg_gram_plain(builder, arrays, *, seg: Optional[Tensor] = None,
                   w: Optional[Tensor] = None,
                   n_segments: int = 1) -> Tensor:
    """The plain segmented Gram over unbatched 2-D inputs.  ``w``:
    (n, 1) row weights; ``seg``: (n,) integer ids (ids outside
    [0, n_segments), e.g. -1 padding, contribute nothing).  Returns
    (qL, qR) without ``seg``, else (n_segments, qL, qR): each segment's
    own rows gathered and multiplied, as the kernel's segment walk
    reads them."""
    L, R = builder(*arrays)
    Lw = L if w is None else L * w
    if seg is None:
        return Lw.T @ R
    out = []
    for s in range(n_segments):
        idx = torch.nonzero(seg == s).squeeze(1)
        out.append(Lw.index_select(0, idx).T @ R.index_select(0, idx))
    return torch.stack(out)
