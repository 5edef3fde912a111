"""Quickstart — the paper's §5.1 listing on the PyTorch/CUDA port.

The original (EconML + Ray):

    est_ray = DML_Ray(model_y=RandomForestRegressor(),
                      model_t=RandomForestClassifier(),
                      model_final=StatsModelsLinearRegression(...),
                      discrete_treatment=True, cv=5)
    est_ray.fit(y, T, X=X, W=None)

Here: the same 5-fold cross-fit DML with the fold-parallel engine (the
fold axis mapped through the task runtime), ridge / logistic nuisances
whose Grams run on the hand-written segment-Gram kernel (row blocks,
strategy "pallas"), the delete-fold jackknife interval, and the
refutation suite — mirroring ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--n 100000] [--p 100]

Runs on the CUDA card by default; ``--device cpu`` runs the plain
versions (pass a smaller ``--n`` there).
"""
import argparse
import time

from repro_torch.config import CausalConfig
from repro_torch.core.dml import DML
from repro_torch.core.refutation import run_all
from repro_torch.data.causal_dgp import paper_demo_data
from repro_torch.device import resolve_device


def main(argv=None):
    """Fit, interval and refutation suite; returns (result, reports,
    true ATE, seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--p", type=int, default=100)
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()

    # the paper's synthetic data: y = (1 + .5 x0) T + x0 + eps,
    # T ~ B(expit(x0))
    print(f"generating synthetic data (n={args.n}, p={args.p}) ...")
    data = paper_demo_data(n=args.n, p=args.p, seed=args.seed, device=dev)

    cfg = CausalConfig(
        n_folds=5,                 # cv=5
        nuisance_y="ridge",        # model_y
        nuisance_t="logistic",     # model_t
        cate_features=2,           # theta(x) = b0 + b1 * x0 (the true CATE)
        discrete_treatment=True,
        engine="parallel",         # the paper's contribution (C1)
        inference="jackknife",     # near-free CI (reuses the fold fits)
        row_block=65536,           # the Grams in row blocks, on the
        row_block_strategy="pallas",  # segment-Gram kernel on the card
    )

    est = DML(cfg, device=dev)
    res = est.fit(data.y, data.t, data.X)
    print(res.summary())
    true_ate = float(data.true_cate.mean())
    print(f"\ntrue ATE = {true_ate:.4f}   "
          f"estimated ATE = {res.ate_of(data.X):.4f}")

    # replicate-based CI (jackknife: k delete-fold re-solves of the final
    # stage mapped through the task runtime, no nuisance refits)
    lo, hi = res.ate_interval()
    print(f"{cfg.inference} {100 * (1 - cfg.alpha):.0f}% CI for theta0: "
          f"[{lo:+.4f}, {hi:+.4f}]")

    print("\nvalidation suite (refutation tests):")
    reports = run_all(cfg, data.y, data.t, data.X, device=dev)
    for report in reports:
        print(" ", report.row())
    secs = time.perf_counter() - t0
    print(f"\nquickstart: {secs:.2f} s on {dev}")
    return res, reports, true_ate, secs


if __name__ == "__main__":
    main()
