"""Streaming sufficient statistics — the estimation substrate shared by
the nuisance fits, the orthogonal final stage and the jackknife.

Every estimator here bottoms out in weighted Gram-shaped moments
``Σ_n w_n d_n d_nᵀ`` (and friends) over a row design ``d``, computed
with a fixed block decomposition:

  row_block = 0   one whole-array block — the plain forms.
  row_block = R   rows are reduced in blocks of R, in FIXED
                  left-to-right order; the ragged last block is
                  zero-padded (padded rows contribute exactly 0.0):

      strategy "whole"    every block partial is computed first, then
                          folded left to right;
      strategy "chunked"  one block at a time, folded as it comes —
                          peak temporaries O(R·q + q²);
      strategy "pallas"   the Gram-shaped forms go through the fused
                          segment-Gram kernel (kernels/seg_gram: the
                          CUDA kernel on the card, its plain version
                          on the CPU).  A form without a fused builder
                          falls back to "chunked" and is counted in
                          ``FALLBACKS[<form>]``.

For equal ``row_block``, "chunked" and "whole" are bitwise equal by
construction: the same block function on the same block shapes, folded
in the same order from the same zero.  Cross-moments ride as appended
design columns (augmented Grams) on the blocked path.

Batching: a weight argument may be (B, n) — the "parallel" cross-fit
engine's fold axis written out, or the bootstrap's replicates times
folds — and the form then returns a leading B.  The weighted final-stage
forms take their residuals, weights and theta with a leading replicate
axis too: one kernel launch for the batch under "pallas", a loop of the
unbatched form otherwise (each replicate's arithmetic is then exactly
that of the replicate alone).

Row-sharded ``DTensor``s (the paper's cell on a device mesh,
``launch/dml_cell.row_sharding``): every form runs on each rank's own
rows — its local shards, one kernel launch there under "pallas" — and
the partial sums are added across the mesh (``sharding.row_sum``), so
the form returns the same whole moments on every rank and no rank holds
another's rows.  The route (whole-array, blocked, fused kernel) is
decided at the global row count, as on one device: a shard of no more
than ``row_block`` rows still takes the blocked route of a global
n > row_block, so under "pallas" each rank launches the kernel on its
shard.  On plain tensors the forms are unchanged.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import is_dtensor, row_sum
from repro_torch.kernels.residual_gram import ops as rg_ops
from repro_torch.kernels.seg_gram import ops as sg_ops

Tensor = torch.Tensor
_F32 = torch.float32

# per-form count of strategy="pallas" calls that fell back to "chunked"
FALLBACKS: Dict[str, int] = {}

# the global row count of the DTensors whose local shards ``_per_shard``
# hands a form: the count its route is decided at (None: the rows given)
_GLOBAL_ROWS: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("moments_global_rows", default=None)


def _sharded_rows(args) -> Optional[int]:
    """The global size of the first dim a mesh dim shards among the
    ``DTensor``s in ``args`` (the rows), else None."""
    from torch.distributed.tensor import Shard
    for a in args:
        if is_dtensor(a):
            for p in a.placements:
                if isinstance(p, Shard):
                    return int(a.shape[p.dim])
    return None


def _per_shard(form):
    """``form`` itself on plain tensors; with a ``DTensor`` argument,
    ``form`` on each rank's local shards, its route decided at the
    global row count, and the partial moments summed across the mesh
    (``sharding.row_sum``)."""

    @functools.wraps(form)
    def wrapped(*args, **kwargs):
        flat = (*args, *kwargs.values())
        if not any(is_dtensor(a) for a in flat):
            return form(*args, **kwargs)
        names = list(kwargs)
        rows = _sharded_rows(flat)

        def local(*loc):
            token = _GLOBAL_ROWS.set(rows)
            try:
                return form(*loc[:len(args)],
                            **dict(zip(names, loc[len(args):])))
            finally:
                _GLOBAL_ROWS.reset(token)

        return row_sum(local, *flat)

    return wrapped


def resolve_row_block(n: int, row_block: Optional[int]) -> int:
    """0 means one whole-array block; any R >= n collapses to that."""
    r = int(row_block or 0)
    return 0 if r <= 0 or r >= n else r


def _route_block(n: int, row_block: Optional[int]) -> int:
    """``resolve_row_block`` at the row count a form's route is decided
    at: the global rows of a row-sharded call (``_per_shard``), else
    ``n``.  Nonzero on a shard of no more than R rows where the global
    n exceeds R: the shard then takes the blocked route, a single block
    of its own rows."""
    g = _GLOBAL_ROWS.get()
    return resolve_row_block(n if g is None else g, row_block)


def _use_pallas(n: int, row_block: int, strategy: Optional[str]) -> bool:
    """The fused kernel engages on the blocked path only."""
    return strategy == "pallas" and _route_block(n, row_block) > 0


def _active_data_mesh():
    """The active DataMesh, if ``repro_torch.runtime.distributed`` is
    loaded and a ``use_data_mesh`` context is open.  The sys.modules
    probe keeps this module free of a runtime-layer import: a mesh can
    only be active once the module that activates it is loaded."""
    import sys
    rd = sys.modules.get("repro_torch.runtime.distributed")
    return None if rd is None else rd.current_data_mesh()


def design(X: Tensor, *, intercept: bool = False,
           append: Optional[Tensor] = None) -> Tensor:
    """The fp32 design ``[X | 1? | append?]``."""
    cols = [X.to(_F32)]
    if intercept:
        cols.append(torch.ones((X.shape[0], 1), dtype=_F32, device=X.device))
    if append is not None:
        a = append.to(_F32)
        cols.append(a[:, None] if a.dim() == 1 else a)
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def _tmap(f, a, b):
    if isinstance(a, tuple):
        return tuple(_tmap(f, x, y) for x, y in zip(a, b))
    return f(a, b)


def _zeros_like(a):
    if isinstance(a, tuple):
        return tuple(_zeros_like(x) for x in a)
    return torch.zeros_like(a)


def _block(a: Tensor, i: int, r: int, pad_value) -> Tensor:
    """Rows [i*r, (i+1)*r) of ``a``, padded to r rows with ``pad_value``."""
    blk = a[i * r:(i + 1) * r]
    short = r - blk.shape[0]
    if short:
        fill = torch.full((short,) + tuple(a.shape[1:]), pad_value,
                          dtype=a.dtype, device=a.device)
        blk = torch.cat([blk, fill], dim=0)
    return blk


def blocked_reduce(block_fn: Callable[..., Any], arrays: Sequence[Tensor],
                   *, row_block: int = 0, strategy: Optional[str] = None,
                   pad_values: Optional[Sequence] = None,
                   init: Optional[Any] = None, form: str = "") -> Any:
    """Reduce ``block_fn`` over row blocks of the leading axis.

    ``block_fn(*blocks)`` returns a tensor or a tuple of tensors; it must
    be row-additive and map padded rows to exactly-zero contributions.
    ``pad_values`` sets the per-array padding constant (-1 for integer
    fold ids).  ``init`` seeds the left fold instead of zeros.  Under
    ``strategy="pallas"`` (a form with no fused builder) the call is
    counted in ``FALLBACKS[form]`` and runs chunked.  Inside
    ``use_data_mesh`` the blocks split over the mesh's ranks
    (``runtime.distributed.dist_reduce``; "ordered": bitwise this
    function's fold)."""
    arrays = tuple(arrays)
    n = arrays[0].shape[0]
    r = resolve_row_block(n, row_block)
    if r == 0:
        out = block_fn(*arrays)
        return out if init is None else _tmap(torch.add, init, out)
    strategy = strategy or "chunked"
    if strategy == "pallas":
        key = form or "unlabeled"
        FALLBACKS[key] = FALLBACKS.get(key, 0) + 1
        strategy = "chunked"
    if strategy not in ("whole", "chunked"):
        raise ValueError(f"unknown strategy {strategy!r} "
                         "(expected whole | chunked | pallas)")
    dm = _active_data_mesh()
    if dm is not None:
        # the blocks split over the mesh's ranks; the ordered reduction
        # replays this function's left fold (runtime.distributed)
        from repro_torch.runtime.distributed import dist_reduce
        return dist_reduce(block_fn, arrays, row_block=r, dm=dm,
                           pad_values=pad_values, init=init)
    pv = tuple(pad_values or (0,) * len(arrays))
    nb = -(-n // r)

    def part(i):
        return block_fn(*[_block(a, i, r, v) for a, v in zip(arrays, pv)])

    if strategy == "whole":
        parts = [part(i) for i in range(nb)]
        acc = _zeros_like(parts[0]) if init is None else init
        for g in parts:
            acc = _tmap(torch.add, acc, g)
        return acc
    g = part(0)
    acc = _tmap(torch.add, _zeros_like(g) if init is None else init, g)
    for i in range(1, nb):
        acc = _tmap(torch.add, acc, part(i))
    return acc


def _stack_each(outs):
    """Per-replicate results (tensors or tuples of tensors) -> stacked."""
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


def _rows(w: Tensor) -> Tensor:
    """Weights with rows leading: (n,) stays, (B, n) -> (n, B) view."""
    w = w.to(_F32)
    return w if w.dim() == 1 else w.T


def _wgram(D: Tensor, w: Tensor) -> Tensor:
    """``Σ_n w_n d_n d_nᵀ``: w (r,) -> (q, q); w (r, B) -> (B, q, q)."""
    if w.dim() == 1:
        return (D * w[:, None]).T @ D
    return torch.stack([(D * w[:, b:b + 1]).T @ D for b in range(w.shape[1])])


# ---------------------------------------------------------------------------
# Weighted moments (ridge / logistic normal equations).
# ---------------------------------------------------------------------------

@_per_shard
def weighted_gram(X: Tensor, w: Tensor, *, intercept: bool = False,
                  append: Optional[Tensor] = None, row_block: int = 0,
                  strategy: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """``G = Σ_n w_n d_n d_nᵀ`` over ``d = [X | 1? | append?]`` plus
    ``n_eff = Σ_n w_n``.  With ``append=y`` the cross-moment is
    ``G[..., :, -1]``."""
    if _use_pallas(X.shape[0], row_block, strategy):
        D = design(X, intercept=intercept, append=append)
        G = sg_ops.design_gram(D, w=w.to(_F32), row_block=row_block)
        return G, w.to(_F32).sum(-1)
    if append is None:
        def block(Xb, wb):
            return _wgram(design(Xb, intercept=intercept), wb), wb.sum(0)
        return blocked_reduce(block, (X, _rows(w)), row_block=row_block,
                              strategy=strategy, form="weighted_gram")

    def block(Xb, ab, wb):
        D = design(Xb, intercept=intercept, append=ab)
        return _wgram(D, wb), wb.sum(0)

    return blocked_reduce(block, (X, append, _rows(w)), row_block=row_block,
                          strategy=strategy, form="weighted_gram")


@_per_shard
def weighted_gram_and_vec(X: Tensor, wg: Tensor, v: Tensor, *,
                          intercept: bool = False, row_block: int = 0,
                          strategy: Optional[str] = None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """One pass returning ``(G = Σ wg_n d_n d_nᵀ, u = Σ v_n d_n,
    n_eff = Σ wg_n)`` — the logistic Newton step's Hessian and gradient.

    row_block = 0 takes the thin ``u = vᵀD`` mat-vec; row_block > 0 reads
    u off the trailing all-ones column of a v-weighted Gram over
    ``[d | 1]`` (the augmented form, chunk-stable)."""
    if _use_pallas(X.shape[0], row_block, strategy):
        D = design(X, intercept=intercept)
        G, u = sg_ops.gram_and_vec(D, wg.to(_F32), v.to(_F32),
                                   row_block=row_block)
        n_eff = blocked_reduce(lambda wb: wb.sum(0), (_rows(wg),),
                               row_block=row_block)
        return G, u, n_eff
    if _route_block(X.shape[0], row_block) == 0:
        D = design(X, intercept=intercept)
        return (_wgram(D, _rows(wg)), v.to(_F32) @ D,
                wg.to(_F32).sum(-1))

    def block(Xb, wb, vb):
        D = design(Xb, intercept=intercept)
        Da = D if intercept else design(Xb, intercept=True)
        Gv = _wgram(Da, vb)
        return _wgram(D, wb), Gv[..., :D.shape[1], -1], wb.sum(0)

    return blocked_reduce(block, (X, _rows(wg), _rows(v)),
                          row_block=row_block, strategy=strategy,
                          form="weighted_gram_and_vec")


# ---------------------------------------------------------------------------
# Fold-segmented moments (the leave-one-out identity of cross-fitting).
# ---------------------------------------------------------------------------

@_per_shard
def fold_gram(X: Tensor, folds: Tensor, k: int, *, intercept: bool = False,
              append: Optional[Tensor] = None, row_block: int = 0,
              strategy: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """``Gh[j] = Σ_{n in fold j} d_n d_nᵀ`` (k, q, q) plus per-fold row
    counts (k,).  Padded fold ids are -1 and match no fold."""
    if _use_pallas(X.shape[0], row_block, strategy):
        D = design(X, intercept=intercept, append=append)
        return sg_ops.fold_design_gram(D, folds, k, row_block=row_block)

    def block(Xb, fb, *rest):
        D = design(Xb, intercept=intercept,
                   append=rest[0] if rest else None)
        ids = torch.arange(k, device=fb.device, dtype=fb.dtype)
        oh = (fb[:, None] == ids[None, :]).to(_F32)
        G = torch.stack([(D * oh[:, j:j + 1]).T @ D for j in range(k)])
        return G, oh.sum(0)

    arrays = (X, folds) + (() if append is None else (append,))
    pad_values = (0, -1) + (() if append is None else (0,))
    return blocked_reduce(block, arrays, row_block=row_block,
                          strategy=strategy, pad_values=pad_values,
                          form="fold_gram")


@_per_shard
def fold_weighted_gram(X: Tensor, Wk: Tensor, *, intercept: bool = False,
                       append: Optional[Tensor] = None, row_block: int = 0,
                       strategy: Optional[str] = None
                       ) -> Tuple[Tensor, Tensor]:
    """``G[k] = Σ_n Wk[k,n] d_n d_nᵀ`` (k, q, q) plus per-fold
    ``n_eff = Σ_n Wk[k,n]`` — the weighted fits' fold (and replicate)
    batched Gram.  ``n_eff`` is a whole-array plain sum in every mode,
    so it does not depend on the strategy."""
    Wk = Wk.to(_F32)
    n_eff = Wk.sum(-1)
    r = _route_block(X.shape[0], row_block)
    if r == 0:
        D = design(X, intercept=intercept, append=append)
        return _wgram(D, Wk.T), n_eff
    if strategy == "pallas":
        D = design(X, intercept=intercept, append=append)
        return sg_ops.fold_weighted_design_gram(D, Wk, row_block=r), n_eff

    def block(Xb, Wb, *rest):
        D = design(Xb, intercept=intercept,
                   append=rest[0] if rest else None)
        return _wgram(D, Wb)

    arrays = (X, Wk.T) + (() if append is None else (append,))
    G = blocked_reduce(block, arrays, row_block=r, strategy=strategy,
                       form="fold_weighted_gram")
    return G, n_eff


# ---------------------------------------------------------------------------
# Residual moments (the DML final stage): Z = (t - mt) ⊙ phi,
# G = ZᵀZ, b = Zᵀ(y - my), meat = Σ e²·z zᵀ.
# ---------------------------------------------------------------------------

@_per_shard
def residual_moments(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                     phi: Tensor, *, row_block: int = 0,
                     strategy: Optional[str] = None
                     ) -> Tuple[Tensor, Tensor]:
    """(G (p,p), b (p,)) of the orthogonal moment, fp32.  row_block=0
    takes the fused ``residual_gram`` (the kernel on the card); the
    blocked path streams the augmented ``M = [Z | ry]`` Gram."""
    n, p = phi.shape
    r = _route_block(n, row_block)
    if r == 0:
        return rg_ops.residual_gram(y, t, my, mt, phi)
    if strategy == "pallas":
        return sg_ops.residual_gram(y, t, my, mt, phi, row_block=r)

    def block(yb, tb, myb, mtb, phib):
        ry = (yb - myb).to(_F32)
        rt = (tb - mtb).to(_F32)
        z = rt[:, None] * phib.to(_F32)
        M = torch.cat([z, ry[:, None]], dim=1)
        Gaug = M.T @ M
        return Gaug[:p, :p], Gaug[:p, p]

    return blocked_reduce(block, (y, t, my, mt, phi), row_block=r,
                          strategy=strategy, form="residual_moments")


@_per_shard
def residual_weighted_gram(ry: Tensor, rt: Tensor, phi: Tensor, w: Tensor,
                           *, row_block: int = 0,
                           strategy: Optional[str] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Weighted augmented residual Gram ``Σ_n w_n m_n m_nᵀ`` with
    ``m = [rt·phi | ry]`` plus ``n_eff = Σ w`` — the weighted final
    stage's moment.  ry, rt, w (n,) or (R, n); phi (n, p) shared."""
    if _use_pallas(phi.shape[0], row_block, strategy):
        return sg_ops.residual_weighted_gram(ry, rt, phi, w,
                                             row_block=row_block)
    if ry.dim() == 2:
        return _stack_each([residual_weighted_gram(
            ry[b], rt[b], phi, w[b], row_block=row_block, strategy=strategy)
            for b in range(ry.shape[0])])

    def block(ryb, rtb, phib, wb):
        Z = rtb.to(_F32)[:, None] * phib.to(_F32)
        M = torch.cat([Z, ryb.to(_F32)[:, None]], dim=1)
        ws = wb.to(_F32)
        return (M * ws[:, None]).T @ M, ws.sum()

    return blocked_reduce(block, (ry, rt, phi, w), row_block=row_block,
                          strategy=strategy, form="residual_weighted_gram")


def _meat_gram(score: Tensor, e: Tensor, p: int) -> Tensor:
    """``Σ_n e_n² s_n s_nᵀ``: ``mᵀm`` with ``m = e·s`` at p >= 2, the
    three-operand form at p = 1 (the reference's width dispatch)."""
    if p >= 2:
        m = e[:, None] * score
        return m.T @ m
    return (score * torch.square(e)[:, None]).T @ score


@_per_shard
def residual_meat(y: Tensor, t: Tensor, my: Tensor, mt: Tensor,
                  phi: Tensor, theta: Tensor, *, w: Optional[Tensor] = None,
                  row_block: int = 0, strategy: Optional[str] = None
                  ) -> Tensor:
    """HC0 meat ``Σ_n (w_n e_n)² z_n z_nᵀ`` with ``e = ry - <z, theta>``,
    streamed per block.  Batched: y, t, my, mt, w (R, n) and theta
    (R, p) -> (R, p, p)."""
    p = phi.shape[1]
    if _use_pallas(phi.shape[0], row_block, strategy):
        return sg_ops.residual_meat(y, t, my, mt, phi, theta, w=w,
                                    row_block=row_block)
    if y.dim() == 2:
        return torch.stack([residual_meat(
            y[b], t[b], my[b], mt[b], phi, theta[b],
            w=None if w is None else w[b], row_block=row_block,
            strategy=strategy) for b in range(y.shape[0])])

    def block(yb, tb, myb, mtb, phib, *rest):
        ry = (yb - myb).to(_F32)
        rt = (tb - mtb).to(_F32)
        z = rt[:, None] * phib.to(_F32)
        e = ry - (z * theta[None, :]).sum(dim=1)
        if rest:
            e = rest[0].to(_F32) * e
        return _meat_gram(z, e, p)

    arrays = (y, t, my, mt, phi) + (() if w is None else (w,))
    return blocked_reduce(block, arrays, row_block=row_block,
                          strategy=strategy, form="residual_meat")


# ---------------------------------------------------------------------------
# Instrumented moments (the orthogonal-IV family, core/iv.py):
# M = [rz ⊙ phi | rt ⊙ phi | ry], G = Σ w · m mᵀ.  Every 2SLS-shaped
# statistic is a slice of this one augmented Gram:
#   J    = G[:p, p:2p]   Σ w·rz·rt·φφᵀ
#   b    = G[:p, 2p]     Σ w·rz·ry·φ
#   Szz  = G[:p, :p]     Σ w·rz²·φφᵀ
#   Stt  = G[p:2p, p:2p] Σ w·rt²·φφᵀ
# ---------------------------------------------------------------------------

def _iv_rows(ryb: Tensor, rtb: Tensor, rzb: Tensor, phib: Tensor) -> Tensor:
    ph = phib.to(_F32)
    return torch.cat([rzb.to(_F32)[:, None] * ph, rtb.to(_F32)[:, None] * ph,
                      ryb.to(_F32)[:, None]], dim=1)


@_per_shard
def iv_gram(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor, w: Tensor, *,
            row_block: int = 0, strategy: Optional[str] = None
            ) -> Tuple[Tensor, Tensor]:
    """Weighted instrumented augmented Gram ``Σ_n w_n m_n m_nᵀ`` with
    ``m = [rz·phi | rt·phi | ry]`` ((2p+1, 2p+1)) plus ``n_eff = Σ w``.
    ry, rt, rz, w (n,) or (R, n); phi (n, p) shared."""
    if _use_pallas(phi.shape[0], row_block, strategy):
        return sg_ops.iv_gram(ry, rt, rz, phi, w, row_block=row_block)
    if ry.dim() == 2:
        return _stack_each([iv_gram(
            ry[b], rt[b], rz[b], phi, w[b], row_block=row_block,
            strategy=strategy) for b in range(ry.shape[0])])

    def block(ryb, rtb, rzb, phib, wb):
        M = _iv_rows(ryb, rtb, rzb, phib)
        ws = wb.to(_F32)
        return (M * ws[:, None]).T @ M, ws.sum()

    return blocked_reduce(block, (ry, rt, rz, phi, w), row_block=row_block,
                          strategy=strategy, form="iv_gram")


def iv_slices(Gaug: Tensor, p: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(J, b, Szz, Stt) read off an ``iv_gram`` result (any leading
    batch)."""
    return (Gaug[..., :p, p:2 * p], Gaug[..., :p, 2 * p],
            Gaug[..., :p, :p], Gaug[..., p:2 * p, p:2 * p])


@_per_shard
def iv_meat(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor, theta: Tensor,
            *, w: Optional[Tensor] = None, row_block: int = 0,
            strategy: Optional[str] = None) -> Tensor:
    """HC0 meat of the instrumented moment: ``Σ_n (w_n e_n)² zc_n zc_nᵀ``
    with score ``zc = rz·phi`` and residual ``e = ry - <rt·phi, theta>``.
    Batched as ``residual_meat``."""
    p = phi.shape[1]
    if _use_pallas(phi.shape[0], row_block, strategy):
        return sg_ops.iv_meat(ry, rt, rz, phi, theta, w=w,
                              row_block=row_block)
    if ry.dim() == 2:
        return torch.stack([iv_meat(
            ry[b], rt[b], rz[b], phi, theta[b],
            w=None if w is None else w[b], row_block=row_block,
            strategy=strategy) for b in range(ry.shape[0])])

    def block(ryb, rtb, rzb, phib, *rest):
        ph = phib.to(_F32)
        z = rtb.to(_F32)[:, None] * ph
        e = ryb.to(_F32) - (z * theta[None, :]).sum(dim=1)
        if rest:
            e = rest[0].to(_F32) * e
        m = e[:, None] * (rzb.to(_F32)[:, None] * ph)
        if p >= 2:
            return m.T @ m
        # p = 1: the plain sum of squares (the reference's form there)
        return torch.square(m[:, 0]).sum().reshape(1, 1)

    arrays = (ry, rt, rz, phi) + (() if w is None else (w,))
    return blocked_reduce(block, arrays, row_block=row_block,
                          strategy=strategy, form="iv_meat")


@_per_shard
def fold_iv_gram(ry: Tensor, rt: Tensor, rz: Tensor, phi: Tensor,
                 folds: Tensor, k: int, *, row_block: int = 0,
                 strategy: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Fold-segmented instrumented Gram ``Gh[j] = Σ_{n in fold j}
    m_n m_nᵀ`` ((k, 2p+1, 2p+1)) plus per-fold row counts — the IV
    jackknife's one pass.  Padded fold ids are -1 and match no fold."""
    if _use_pallas(phi.shape[0], row_block, strategy):
        return sg_ops.fold_iv_gram(ry, rt, rz, phi, folds, k,
                                   row_block=row_block)

    def block(ryb, rtb, rzb, phib, fb):
        M = _iv_rows(ryb, rtb, rzb, phib)
        ids = torch.arange(k, device=fb.device, dtype=fb.dtype)
        oh = (fb[:, None] == ids[None, :]).to(_F32)
        G = torch.stack([(M * oh[:, j:j + 1]).T @ M for j in range(k)])
        return G, oh.sum(0)

    return blocked_reduce(block, (ry, rt, rz, phi, folds),
                          row_block=row_block, strategy=strategy,
                          pad_values=(0, 0, 0, 0, -1), form="fold_iv_gram")
