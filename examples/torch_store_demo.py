"""Effect-store demo on the PyTorch/CUDA port: days of arriving data,
refreshed two ways — re-fitting the whole panel from scratch every day
(the practitioner's baseline) vs folding ONLY the new rows into a
persistent ``MomentStore`` and re-solving from moments — after
``examples/store_demo.py``.  At these row-blocked shapes the two are
bitwise identical, day after day.

    PYTHONPATH=src python examples/torch_store_demo.py [--device cpu]
        [--days 5] [--n 4096] [--p 10] [--e 8]

Runs on the CUDA card by default, each day's Grams on the segment-Gram
kernel (row_block_strategy "pallas"), whose walk starts from the
store's moments, so an ingest is bitwise the one-shot pass.  On the CPU
the demo takes the "chunked" strategy, the reference demo's bitwise
days: there the "pallas" forms' plain versions add a day's moments to
the store's (the reference's arithmetic, not bitwise a one-shot pass).
``--strategy`` overrides the device's choice; the port's tests take
"pallas" on the CPU to count the launches the card would make.
Snapshots go to a temporary directory removed at the end.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import CausalConfig
from repro_torch.data.causal_dgp import make_causal_data
from repro_torch.device import resolve_device
from repro_torch.store import MomentStore
from repro_torch.sweep.spec import SweepSpec


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """The daily loop; returns a dict with each day's bitwise verdict
    and seconds, the store's version, the latest snapshot and the last
    panel's per-segment ATEs."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--days", type=int, default=5)
    ap.add_argument("--n", type=int, default=4096, help="rows a day")
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--e", type=int, default=8, help="segments")
    ap.add_argument("--strategy", default=None,
                    choices=("pallas", "chunked"),
                    help="default: pallas on the card, chunked on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    strategy = args.strategy or ("pallas" if dev.type == "cuda"
                                 else "chunked")
    days, n_day, P, E = args.days, args.n, args.p, args.e
    t_start = time.perf_counter()

    total = n_day * days
    data = make_causal_data(total, P, seed=args.seed, device=dev,
                            effect=1.0, discrete_treatment=False)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    sids = torch.randint(0, E, (total,), generator=g, device=dev)

    # the reference's settings; "pallas": the row blocks' Grams on the
    # segment-Gram kernel on the card (its plain version on the CPU)
    cfg = CausalConfig(n_folds=3, inference="none", row_block=1024,
                       row_block_strategy=strategy, nuisance_t="ridge",
                       discrete_treatment=False)
    spec = SweepSpec(n_segments=E, columns=(("dml", cfg),))

    def day(d):
        lo, hi = d * n_day, (d + 1) * n_day
        return dict(X=data.X[lo:hi], y=data.y[lo:hi], t=data.t[lo:hi],
                    segment_ids=sids[lo:hi])

    store = MomentStore(spec, n_features=P, seed=args.seed, device=dev)
    bitwise, t_incs, t_fulls = [], [], []
    with tempfile.TemporaryDirectory(prefix="store_demo_") as tmp:
        ckpt = CheckpointManager(tmp)
        print(f"{days} days x {n_day} rows/day, {E} segments, "
              f"row_block={cfg.row_block} ({strategy}), on {dev}\n")
        print("day   rows_seen  ingest+refresh   full_refit   speedup  "
              "bitwise")
        for d in range(days):
            # incremental: fold ONLY today's rows into the standing store
            _sync(dev)
            t0 = time.perf_counter()
            store.ingest(**day(d))
            panel = store.refresh()
            _sync(dev)
            t_inc = time.perf_counter() - t0
            store.save(ckpt)  # versioned snapshot (hot-swap / rollback)

            # baseline: rebuild from scratch over ALL rows seen so far
            t0 = time.perf_counter()
            refit = MomentStore(spec, n_features=P, seed=args.seed,
                                device=dev)
            hi = (d + 1) * n_day
            refit.ingest(X=data.X[:hi], y=data.y[:hi], t=data.t[:hi],
                         segment_ids=sids[:hi])
            full = refit.refresh()
            _sync(dev)
            t_full = time.perf_counter() - t0

            same = torch.equal(panel.columns[0].thetas,
                               full.columns[0].thetas)
            bitwise.append(bool(same))
            t_incs.append(t_inc)
            t_fulls.append(t_full)
            print(f"  {d}   {store.n_total:9d}  {t_inc:12.4f}s  "
                  f"{t_full:9.4f}s  {t_full / t_inc:6.2f}x  {same}")
        ckpt.wait()
        latest = ckpt.latest_step()

    col = store.refresh().columns[0]
    print(f"\nstore at version {store.version} (checkpoints: {latest} "
          "latest)")
    print("per-segment ATE after the last day:",
          [round(float(a), 3) for a in col.ates.cpu()])
    secs = time.perf_counter() - t_start
    print(f"\nstore demo: {secs:.2f} s on {dev}")
    return {"bitwise": bitwise, "ingest_refresh_s": t_incs,
            "full_refit_s": t_fulls, "version": store.version,
            "latest": latest, "ates": col.ates, "seconds": secs}


if __name__ == "__main__":
    main()
