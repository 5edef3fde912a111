"""Bootstrap confidence intervals on the PyTorch/CUDA port.

EconML equivalent (the expensive path the paper hands to Ray — B full
re-estimations scheduled as tasks):

    est = LinearDML(...)
    est.fit(y, T, X=X, inference=BootstrapInference(n_bootstrap_samples=200))
    est.ate_interval(X)

Here the B replicates are weighted refits with the replicate axis
written out as a leading batch dimension: the "vmap" executor runs
``runtime_chunk`` replicates per batched fit, and on the card every
weighted Gram of a chunk is one launch of the hand-written segment-Gram
kernel (row_block > 0, strategy "pallas").

    PYTHONPATH=src python examples/torch_inference_demo.py \\
        [--n 100000] [--p 50] [--device cpu]

Runs on the CUDA card by default; ``--device cpu`` runs the plain
versions (the default n is then 5,000 and p 10).
"""
import argparse
import time

from repro_torch.config import CausalConfig
from repro_torch.core.dml import DML
from repro_torch.data.causal_dgp import make_causal_data
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="default: the CUDA card")
ap.add_argument("--n", type=int, default=None,
                help="rows (default 100000 on the card, 5000 on the CPU)")
ap.add_argument("--p", type=int, default=None,
                help="covariates (default 50 on the card, 10 on the CPU)")
ap.add_argument("--replicates", type=int, default=200)
ap.add_argument("--seed", type=int, default=42)
args = ap.parse_args()

dev = resolve_device(args.device)
on_card = dev.type == "cuda"
n = args.n or (100_000 if on_card else 5_000)
p = args.p or (50 if on_card else 10)
data = make_causal_data(n, p, seed=args.seed, device=dev,
                        heterogeneous=True, effect=1.0)

cfg = CausalConfig(
    n_folds=5,
    cate_features=2,            # theta(x) = b0 + b1·x0
    inference="bootstrap",      # pairs bootstrap (multiplier | jackknife)
    n_bootstrap=args.replicates,  # EconML's n_bootstrap_samples
    alpha=0.05,
    inference_executor="vmap",  # replicates as a batch dimension
    runtime_chunk=25,           # replicates per batched fit
    row_block=4096,             # blocked moments: the kernel on the card
    row_block_strategy="pallas",
)

res = DML(cfg, device=dev).fit(data.y, data.t, data.X)
print(f"n={n} p={p} on {dev}")
print(f"true ATE      : {data.true_ate:+.4f}")
print(f"estimated ATE : {res.ate_of(data.X):+.4f}")

t0 = time.perf_counter()
lo, hi = res.ate_interval()               # B batched weighted refits
secs = time.perf_counter() - t0
print(f"bootstrap CI  : [{lo:+.4f}, {hi:+.4f}]  (percentile, "
      f"B={args.replicates}, {secs:.1f} s)")

jk = res.inference(method="jackknife")    # near-free: reuses fold fits
print(f"jackknife CI  : [{jk.ate_interval()[0]:+.4f}, "
      f"{jk.ate_interval()[1]:+.4f}]")
print(f"IF sandwich se: {float(res.stderr[0]):.4f}  "
      f"jackknife se: {float(jk.se[0]):.4f}  "
      f"bootstrap se: {float(res.inference().se[0]):.4f}")

# pointwise CATE bands at a few covariate profiles
Xq = data.X[:5]
band_lo, band_hi = res.cate_interval(Xq)
cate = res.cate(Xq)
for i in range(5):
    print(f"CATE(x{i}): {float(cate[i]):+.3f} in "
          f"[{float(band_lo[i]):+.3f}, {float(band_hi[i]):+.3f}]  "
          f"(true {float(data.true_cate[i]):+.3f})")
