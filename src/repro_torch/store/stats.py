"""Ingest-side sufficient statistics of the effect store.

The store's unit of state is the per-(segment, fold) cell.  Each cell
holds two Gram-additive accumulators over the nuisance design
``dn = [X | 1 | t | y]`` (``[... | z]`` for the instrumented family):

  ng      (cells, qd, qd)   ``Σ_n dn_n dn_nᵀ`` — the nuisance fold
          Gram.  Its fold-complement (the leave-one-out identity) is
          every cross-fit ridge normal equation at once.
  vg      (cells, pf·qd, pf·qd)   ``Σ_n v_n v_nᵀ`` with
          ``v = φ(x) ⊗ dn`` — the degree-4 moment tensor.  Every
          final-stage statistic is a *contraction* of vg with per-cell
          residual coefficient vectors (a residual is linear in dn), so
          refresh never re-reads a row.
  counts  (cells,)   exact integer row counts (f32 sums of integers
          are order-independent below 2²⁴).

Ingest folds a new row block into all three with one pass over only
the new rows, seeded with the standing accumulators:

  "chunked" / "whole"  ``moments.blocked_reduce(init=state)``: the
          seeded left fold replays exactly the addition sequence a
          one-shot pass over the concatenated rows would run, so
          incremental ingest is **bitwise** the full rebuild whenever
          every earlier ingest ended on a ``row_block`` boundary.
  "pallas"  ``segment_outer(init=state)``: on the card the segment walk
          starts each cell's accumulators from the standing ones and
          walks the cell's new rows in arrival order without splitting
          — bitwise the one-shot pass whatever the ingest boundaries;
          on the CPU the plain version adds the new rows' Gram to the
          standing one (tolerance-equal, as the reference's kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import moments
from repro_torch.kernels.seg_gram import ops as sg_ops

Tensor = torch.Tensor
_F32 = torch.float32

State = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class ColumnLayout:
    """Static shape metadata of one store column's accumulators."""

    p: int    # X feature width
    pf: int   # CATE basis width (cate_basis column count)
    k: int    # cross-fit folds
    iv: bool  # instrumented design (z column present)

    @property
    def q(self) -> int:
        """Augmented nuisance design width [X | 1]."""
        return self.p + 1

    @property
    def it(self) -> int:
        """Column index of t inside dn."""
        return self.q

    @property
    def iy(self) -> int:
        """Column index of y inside dn."""
        return self.q + 1

    @property
    def iz(self) -> int:
        """Column index of z inside dn (instrumented layouts only)."""
        return self.q + 2

    @property
    def qd(self) -> int:
        """Full dn width."""
        return self.q + (3 if self.iv else 2)

    @property
    def pv(self) -> int:
        """Width of the Khatri-Rao row ``v = φ ⊗ dn``."""
        return self.pf * self.qd


def init_state(layout: ColumnLayout, n_cells: int, device=None) -> State:
    """Zero accumulators for ``n_cells = n_segments · k`` cells."""
    return {
        "ng": torch.zeros((n_cells, layout.qd, layout.qd), dtype=_F32,
                          device=device),
        "vg": torch.zeros((n_cells, layout.pv, layout.pv), dtype=_F32,
                          device=device),
        "counts": torch.zeros((n_cells,), dtype=_F32, device=device),
    }


def _dn(layout: ColumnLayout, X: Tensor, t: Tensor, y: Tensor,
        z: Optional[Tensor]) -> Tensor:
    n = X.shape[0]
    cols = [X.to(_F32), torch.ones((n, 1), dtype=_F32, device=X.device),
            t.to(_F32).reshape(n, 1), y.to(_F32).reshape(n, 1)]
    if layout.iv:
        cols.append(z.to(_F32).reshape(n, 1))
    return torch.cat(cols, dim=1)


def _vrow(layout: ColumnLayout, phi: Tensor, dn: Tensor) -> Tensor:
    v = phi.to(_F32)[:, :, None] * dn[:, None, :]
    return v.reshape(dn.shape[0], layout.pv)


def _cell_grams(M: Tensor, oh: Tensor) -> Tensor:
    """``Σ_n oh[n, c] M_n M_nᵀ`` per cell: (cells, q, q), one masked
    product per cell."""
    return torch.stack([(M * oh[:, c:c + 1]).T @ M
                        for c in range(oh.shape[1])])


def ingest_cells(layout: ColumnLayout, state: State, X: Tensor, t: Tensor,
                 y: Tensor, z: Optional[Tensor], phi: Tensor, comb: Tensor,
                 n_cells: int, *, row_block: int = 0,
                 strategy: Optional[str] = None) -> State:
    """Fold a row block into the standing cell accumulators (a new
    state; ``state`` is not written).

    ``comb`` is the combined cell id ``segment·k + fold`` per row.  One
    pass over ONLY the new rows; history is never re-touched.
    """
    if strategy == "pallas":
        dn = _dn(layout, X, t, y, z)
        v = _vrow(layout, phi, dn)
        return {
            "ng": sg_ops.segment_outer(dn, dn, comb, n_cells,
                                       init=state["ng"], row_block=row_block),
            "vg": sg_ops.segment_outer(v, v, comb, n_cells,
                                       init=state["vg"], row_block=row_block),
            "counts": state["counts"] + sg_ops.segment_counts(comb, n_cells),
        }

    def block(Xb, tb, yb, *rest):
        if layout.iv:
            zb, phib, cb = rest
        else:
            (phib, cb), zb = rest, None
        dn = _dn(layout, Xb, tb, yb, zb)
        v = _vrow(layout, phib, dn)
        oh = (cb[:, None] == torch.arange(n_cells, device=cb.device)
              ).to(_F32)
        return (_cell_grams(dn, oh), _cell_grams(v, oh), oh.sum(0))

    arrays = (X, t, y) + ((z,) if layout.iv else ()) + (phi, comb)
    pad_values = (0,) * (len(arrays) - 1) + (-1,)
    init = (state["ng"], state["vg"], state["counts"])
    ng, vg, counts = moments.blocked_reduce(
        block, arrays, row_block=row_block, strategy=strategy,
        pad_values=pad_values, init=init, form="store_ingest")
    return {"ng": ng, "vg": vg, "counts": counts}
