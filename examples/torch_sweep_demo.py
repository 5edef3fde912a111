"""Segment-parallel sweep demo on the PyTorch/CUDA port: estimate one
effect PER user segment — the paper's many-cohorts workload — as
batched programs, then compare against the practitioner's groupby loop
(``examples/sweep_demo.py`` on the card).

    PYTHONPATH=src python examples/torch_sweep_demo.py [--device cpu]
        [--n 16384] [--p 10] [--e 16] [--b 32]

Runs on the CUDA card by default; ``--device cpu`` runs the plain
versions (pass a smaller ``--n`` / ``--b`` there).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.sweep_synthetic import SWEEP
from repro_torch.data.causal_dgp import make_causal_data
from repro_torch.device import resolve_device
from repro_torch.sweep import SweepSpec, serial_loop, sweep


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """The cells panel (a point column and a bootstrap column), the
    serial loop it equals bitwise and the segmented one-pass sweep;
    returns a dict of the three and their seconds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--p", type=int, default=10)
    ap.add_argument("--e", type=int, default=16, help="segments")
    ap.add_argument("--b", type=int, default=32,
                    help="bootstrap replicates of the CI column")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N, P, E = args.n, args.p, args.e
    t_start = time.perf_counter()

    data = make_causal_data(N, P, seed=args.seed, device=dev, effect=1.0,
                            heterogeneous=True)
    # synthetic cohort assignment (in production: a user-segment column)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    sids = torch.randint(0, E, (N,), generator=g, device=dev)

    # the reference's settings, with the row blocks' Grams on the
    # segment-Gram kernel on the card (its plain version on the CPU)
    cfg = dataclasses.replace(SWEEP, n_folds=3, row_block=1024,
                              row_block_strategy="pallas")
    cfg_ci = dataclasses.replace(cfg, inference="bootstrap",
                                 n_bootstrap=args.b)

    # two columns: a point sweep + a bootstrap-CI sweep — the CI
    # column's (cell x replicate) axes run through runtime.map_product
    spec = SweepSpec(n_segments=E, columns=(("dml", cfg), ("dml", cfg_ci)),
                     segment_key=SWEEP.segment_key)
    t0 = time.perf_counter()
    panel = sweep(spec, X=data.X, y=data.y, t=data.t, segment_ids=sids,
                  seed=args.seed, executor="vmap", device=dev)
    _sync(dev)
    t_panel = time.perf_counter() - t0
    print(f"batched panel ({spec.n_cells} cells): {t_panel:.2f}s on {dev}")
    print(panel.summary())

    # per-segment ATEs with bootstrap CIs
    ci = panel.columns[1]
    print(f"\nper-segment ATE [bootstrap {100 * (1 - cfg.alpha):.0f}% CI]:")
    for s in range(E):
        print(f"  segment {s:2d} (n={int(panel.counts[s]):5d}): "
              f"{float(ci.ates[s]):+.3f} "
              f"[{float(ci.ci_lo[s]):+.3f}, {float(ci.ci_hi[s]):+.3f}]")

    # the loop the panel replaces — and equals, bitwise
    t0 = time.perf_counter()
    loop = serial_loop("dml", cfg, X=data.X, y=data.y, t=data.t,
                       segment_ids=sids, n_segments=E, seed=args.seed,
                       device=dev)
    _sync(dev)
    t_loop = time.perf_counter() - t0
    same = torch.equal(panel.columns[0].thetas, loop["theta"])
    print(f"\nserial loop of {E} single fits: {t_loop:.2f}s; "
          f"panel == loop bitwise: {same}")

    # the one-pass segmented execution (one fold draw, the segment walk)
    t0 = time.perf_counter()
    seg = sweep(SweepSpec(n_segments=E, columns=(("dml", cfg),)),
                X=data.X, y=data.y, t=data.t, segment_ids=sids,
                seed=args.seed, mode="segmented", device=dev)
    _sync(dev)
    t_seg = time.perf_counter() - t0
    delta = float((seg.columns[0].ates - panel.columns[0].ates).abs().mean())
    print(f"segmented one-pass sweep: {t_seg:.2f}s (mean |Δ| vs cells "
          f"{delta:.3f} — a different fold draw, same estimator)")
    secs = time.perf_counter() - t_start
    print(f"\nsweep demo: {secs:.2f} s on {dev}")
    return {"panel": panel, "loop": loop, "bitwise": bool(same),
            "segmented": seg, "panel_s": t_panel, "loop_s": t_loop,
            "segmented_s": t_seg, "seconds": secs}


if __name__ == "__main__":
    main()
