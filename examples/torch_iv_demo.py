"""Orthogonal-IV demo on the PyTorch/CUDA port: when an unobserved
confounder drives treatment, DML is biased and an instrument rescues
the estimand — ``examples/iv_demo.py`` on the card.

EconML equivalent (the estimators the paper's catalogue parallelizes
alongside DML):

    est = OrthoIV(...)                   # or DRIV(...)
    est.fit(y, T, Z=Z, X=X)
    est.ate_interval(X)

Here the three nuisances (E[Y|X], E[T|X], E[Z|X]) cross-fit through the
same fold-parallel engine as DML, the residual-on-residual 2SLS moment
comes off one instrumented Gram (the segment-Gram kernel's iv builder on
the card), and the B bootstrap refits run as batched programs through
the task runtime.

    PYTHONPATH=src python examples/torch_iv_demo.py [--device cpu]
        [--n 8000] [--p 10] [--b 200]

Runs on the CUDA card by default; ``--device cpu`` runs the plain
versions (pass a smaller ``--n`` / ``--b`` there).
"""
import argparse
import time

import torch

from repro_torch.config import CausalConfig
from repro_torch.core import DML, DRIV, OrthoIV
from repro_torch.core.refutation import weak_instrument
from repro_torch.data.causal_dgp import make_iv_data
from repro_torch.device import resolve_device


def main(argv=None):
    """Naive DML, OrthoIV with its bootstrap and jackknife intervals,
    DRIV and the weak-instrument screen; returns a dict of the results
    and the seconds they took."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--n", type=int, default=8_000)
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--b", type=int, default=200,
                    help="bootstrap replicates")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()

    data = make_iv_data(args.n, args.p, seed=args.seed, device=dev,
                        effect=1.5, compliance=0.7)
    cfg = CausalConfig(
        n_folds=5,
        nuisance_z="logistic",      # instrument model E[Z|X]
        inference="bootstrap",
        n_bootstrap=args.b,
        inference_executor="vmap",  # the B IV refits as batched programs
        row_block=1024,             # the Grams in row blocks, on the
        row_block_strategy="pallas",  # segment-Gram kernel on the card
    )

    def gen():
        return torch.Generator().manual_seed(0)

    print(f"true LATE       : {data.true_late:+.4f}")

    naive = DML(cfg, device=dev).fit(data.y, data.t, data.X, gen=gen())
    print(f"naive DML ATE   : {naive.ate:+.4f}   <- confounded (no instrument)")

    res = OrthoIV(cfg, device=dev).fit(data.y, data.t, data.z, data.X,
                                       gen=gen())
    se = float(res.stderr[0])
    print(f"OrthoIV LATE    : {res.late:+.4f} ± {se:.4f}")

    boot = res.late_interval()              # B batched replicates
    print(f"bootstrap CI    : [{boot[0]:+.4f}, {boot[1]:+.4f}]  "
          f"(percentile, B={args.b})")

    jk = res.inference(method="jackknife")  # one segmented pass
    jack = jk.ate_interval()
    print(f"jackknife CI    : [{jack[0]:+.4f}, {jack[1]:+.4f}]")

    dr = DRIV(cfg, device=dev).fit(data.y, data.t, data.z, data.X, gen=gen())
    print(f"DRIV LATE       : {dr.late:+.4f} ± {dr.stderr:.4f}")

    weak = weak_instrument(res)
    print()
    print(weak.row())
    print()
    print(res.summary())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    print(f"\niv demo: {secs:.2f} s on {dev}")
    return {"true_late": data.true_late, "naive_ate": naive.ate,
            "late": res.late, "se": se, "bootstrap_ci": boot,
            "jackknife_ci": jack, "driv_late": dr.late,
            "driv_se": dr.stderr, "weak": weak, "result": res,
            "seconds": secs}


if __name__ == "__main__":
    main()
