"""Delete-fold jackknife — uncertainty almost for free.

Cross-fitting already partitions the rows into k folds.  The delete-
group jackknife is ONE fold-segmented augmented residual Gram over the
data (optionally streamed in row blocks), after which each delete-fold
estimate is the LOO identity ``G_(-j) = G_total - G_fold_j`` plus a
(p_phi, p_phi) solve: the k delete-fold solves map through the task
runtime like bootstrap replicates (one batched ``det_solve`` on the
"vmap" backend; the downgrade ladder applies, chunking is moot at k).

    se² = (k-1)/k · Σ_j (θ_(-j) - θ̄)²

``delete_fold_jackknife_iv`` does the same for the instrumented moment.
"""
from __future__ import annotations

import torch

from repro_torch.core import moments
from repro_torch.inference.intervals import InferenceResult
from repro_torch.inference.numerics import det_solve

Tensor = torch.Tensor
_F32 = torch.float32


def delete_fold_jackknife(y: Tensor, t: Tensor, oof_y: Tensor,
                          oof_t: Tensor, folds: Tensor, phi: Tensor,
                          n_folds: int, *, alpha: float = 0.05,
                          executor="vmap", point=None, point_se=None,
                          ridge: float = 1e-8, row_block: int = 0,
                          memory_budget: int = 0, chunk: int = 0,
                          max_retries: int = 2, tracer=None
                          ) -> InferenceResult:
    """Jackknife over the existing fold partition.  y, t, oof_y, oof_t,
    folds: (n,); phi: (n, p_phi).  The k delete-fold solves map through
    the task runtime (``executor`` a name, Executor or TaskRuntime)."""
    from repro_torch.runtime import as_runtime
    sched = as_runtime(executor, memory_budget=memory_budget, chunk=chunk,
                       max_retries=max_retries, tracer=tracer)
    n, p = phi.shape
    k = int(n_folds)
    ry = y.to(_F32) - oof_y
    rt = t.to(_F32) - oof_t

    # one segmented pass: Gh[j] = Σ_{i in fold j} m_i m_iᵀ, m = [Z | ry]
    def block(ryb, rtb, phib, fb):
        Z = rtb[:, None] * phib.to(_F32)
        M = torch.cat([Z, ryb[:, None]], dim=1)
        ids = torch.arange(k, device=fb.device, dtype=fb.dtype)
        oh = (fb[:, None] == ids[None, :]).to(_F32)
        G = torch.stack([(M * oh[:, j:j + 1]).T @ M for j in range(k)])
        return G, oh.sum(0)

    Gh, counts = moments.blocked_reduce(block, (ry, rt, phi, folds),
                                        row_block=row_block,
                                        pad_values=(0, 0, 0, -1))
    G_tot = Gh.sum(0)
    n_eff = torch.clamp(n - counts, min=1.0)                  # (k,)
    eye = torch.eye(p, dtype=_F32, device=phi.device)

    def drop_fold(seg, G_tot_):
        Gd = G_tot_[None] - seg["G"]
        A = Gd[:, :p, :p] + ridge * seg["n_eff"][:, None, None] * eye
        return det_solve(A, Gd[:, :p, p])

    thetas = sched.map(drop_fold, {"G": Gh, "n_eff": n_eff}, G_tot,
                    label="jackknife")
    return _jackknife_result(thetas, k, point, point_se, alpha, sched.name)


def _jackknife_result(thetas: Tensor, n_folds: int, point, point_se,
                      alpha: float, executor_name: str) -> InferenceResult:
    theta_bar = thetas.mean(dim=0)
    center = theta_bar if point is None else point
    k = float(n_folds)
    se = torch.sqrt(torch.clamp(
        (k - 1.0) / k * torch.square(thetas - theta_bar[None, :]).sum(dim=0),
        min=0.0))
    return InferenceResult(method="jackknife", executor=executor_name,
                           point=center, replicates=thetas, se=se,
                           alpha=alpha, point_se=point_se)


def delete_fold_jackknife_iv(y: Tensor, t: Tensor, z: Tensor, oof_y: Tensor,
                             oof_t: Tensor, oof_z: Tensor, folds: Tensor,
                             phi: Tensor, n_folds: int, *,
                             alpha: float = 0.05, executor="vmap",
                             point=None, point_se=None, ridge: float = 1e-8,
                             row_block: int = 0, strategy=None,
                             memory_budget: int = 0, chunk: int = 0,
                             max_retries: int = 2, tracer=None
                             ) -> InferenceResult:
    """Delete-fold jackknife of the instrumented moment: one
    fold-segmented instrumented Gram (``moments.fold_iv_gram``: the
    kernel's iv builder with k segments on the card under "pallas"),
    then each delete-fold 2SLS estimate is ``G_(-j) = G_total - G_j``
    plus one solve, the k solves mapped through the task runtime."""
    from repro_torch.runtime import as_runtime
    sched = as_runtime(executor, memory_budget=memory_budget, chunk=chunk,
                       max_retries=max_retries, tracer=tracer)
    n, p = phi.shape
    k = int(n_folds)
    ry = y.to(_F32) - oof_y
    rt = t.to(_F32) - oof_t
    rz = z.to(_F32) - oof_z
    Gh, counts = moments.fold_iv_gram(ry, rt, rz, phi, folds, k,
                                      row_block=row_block, strategy=strategy)
    n_eff = torch.clamp(n - counts, min=1.0)
    eye = torch.eye(p, dtype=_F32, device=phi.device)

    def drop_fold(seg, G_tot):
        Gd = G_tot[None] - seg["G"]
        J, b, _, _ = moments.iv_slices(Gd, p)
        return det_solve(J + ridge * seg["n_eff"][:, None, None] * eye, b)

    thetas = sched.map(drop_fold, {"G": Gh, "n_eff": n_eff}, Gh.sum(0),
                    label="jackknife_iv")
    return _jackknife_result(thetas, k, point, point_se, alpha, sched.name)
