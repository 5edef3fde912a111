"""The wave scorer: ``phi(x) · thetas[segment]`` per row, with analytic
CI bands from the stored standard errors.

Structure is the certification:

  * Every number of row i (basis, theta gather, effect, SE band) is
    computed from row i alone by elementwise operations: the pf ≤ a few
    basis terms are summed one at a time, left to right, with one
    multiply and one add per term — never a reduction over an axis,
    whose order may depend on the tensor's length.  So a row scored in
    a wave of any size, or alone (``score_single``, 0-dim inputs), gets
    the same bits, on the CPU and on the card: batched ≡ unbatched, and
    padded slots are no-ops.
  * Padded slots follow the segment-Gram convention: ``sid = -1``.  An
    out-of-range segment id reads the clamped index 0 but is flagged
    ``ok = False`` and zeroed on the way out.
  * Failed panel cells (``ok[sid] = False``: zero-row segments,
    non-finite solves) return a flagged response — ``ok = False`` and
    zeroed effect and CI fields, never NaN.

The band uses the diagonal approximation se(phi·theta)² ≈ Σ_a phi_a²
se_a² (the panel stores SEs, not the covariance; exact at pf = 1, the
one-ATE-per-segment panel).
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor
_F32 = torch.float32


def score_rows(thetas: Tensor, ses: Tensor, ok: Tensor, X: Tensor,
               sids: Tensor, z: Tensor) -> Dict[str, Tensor]:
    """Score requests against one panel version: X (..., p) fp32 and
    sids (...) int64 (-1 = padded slot) on the panel's device; z the
    0-dim fp32 critical value.  Returns {cate, lo, hi, se, ok}, each of
    sids' shape (a wave (W,), or 0-dim for one request)."""
    n_segments, pf = thetas.shape
    valid = (sids >= 0) & (sids < n_segments)
    s = torch.clamp(sids, 0, n_segments - 1)
    th, se = thetas[s], ses[s]                        # (..., pf)
    # phi = [1, x_0, .., x_{pf-2}]: the constant term, then one term at a
    # time
    cate = th[..., 0]
    var = se[..., 0] * se[..., 0]
    for a in range(1, pf):
        x = X[..., a - 1]
        cate = cate + x * th[..., a]
        var = var + x * x * se[..., a] * se[..., a]
    band = torch.sqrt(torch.clamp(var, min=0.0))
    good = valid & ok[s] & torch.isfinite(cate)
    zero = torch.zeros((), dtype=_F32, device=thetas.device)
    return {"cate": torch.where(good, cate, zero),
            "lo": torch.where(good, cate - z * band, zero),
            "hi": torch.where(good, cate + z * band, zero),
            "se": torch.where(good, band, zero),
            "ok": good}


def _z(z: float, device) -> Tensor:
    return torch.tensor(z, dtype=_F32, device=device)


def score_batch(panel, X, sids, z: float) -> Dict[str, Tensor]:
    """The server's wave entry point: ``panel`` a ``ServingPanel``, X
    (W, p) and sids (W,) as arrays or tensors (moved to the panel's
    device in one copy each), z the CI critical value."""
    dev = panel.device
    X = torch.as_tensor(X, dtype=_F32).to(dev)
    sids = torch.as_tensor(sids).to(device=dev, dtype=torch.int64)
    return score_rows(panel.thetas, panel.ses, panel.ok, X, sids, _z(z, dev))


def score_single(panel, x, segment_id: int, z: float) -> Dict[str, Tensor]:
    """The unbatched scorer: ONE request as 0-dim tensors — no wave, no
    padding — the yardstick batched serving is certified against."""
    dev = panel.device
    x = torch.as_tensor(x, dtype=_F32).to(dev)
    sid = torch.tensor(int(segment_id), dtype=torch.int64, device=dev)
    return score_rows(panel.thetas, panel.ses, panel.ok, x, sid, _z(z, dev))
