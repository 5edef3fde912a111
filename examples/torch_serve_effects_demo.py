"""Effect-serving demo on the PyTorch/CUDA port: ingest a day, refresh,
hot-swap, score a burst.

The production loop on one host:

  day 1 arrives -> MomentStore.ingest -> save (version 1)
  an EffectServer loads v1 from the checkpoint and serves traffic
  day 2 arrives -> ingest -> save (version 2)
  the server hot-swaps to v2 between waves (no request mixes versions),
  serves more traffic, then rolls back to v1 to show the escape hatch.

    PYTHONPATH=src python examples/torch_serve_effects_demo.py [--device cpu]

Runs on the CUDA card by default (the store's accumulators, the panels
and every wave's scoring live there); ``--device cpu`` runs the plain
versions.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import CausalConfig
from repro_torch.data.causal_dgp import make_causal_data
from repro_torch.device import resolve_device
from repro_torch.serve_effects import EffectServer, panel_from_checkpoint
from repro_torch.store import MomentStore
from repro_torch.sweep import SweepSpec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    n_day, p, n_segments, seed = 4096, 10, 8, 0
    data = make_causal_data(2 * n_day, p, seed=seed, device=dev,
                            discrete_treatment=False)
    sids = torch.randint(0, n_segments, (2 * n_day,),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    cfg = CausalConfig(n_folds=3, inference="none", row_block=1024,
                       row_block_strategy="pallas", nuisance_t="ridge",
                       discrete_treatment=False, cate_features=2)
    spec = SweepSpec(n_segments=n_segments, columns=(("dml", cfg),))

    def day(lo, hi):
        return dict(X=data.X[lo:hi], y=data.y[lo:hi], t=data.t[lo:hi],
                    segment_ids=sids[lo:hi])

    with tempfile.TemporaryDirectory() as ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep_latest=4)

        # --- estimation side: the daily ingest loop --------------------
        store = MomentStore(spec, n_features=p, seed=seed, device=dev)
        store.ingest(**day(0, n_day))
        v1 = store.save(manager)
        print(f"day 1 ingested on {dev} -> checkpoint version {v1}")

        # --- serving side: load v1, serve a burst ----------------------
        panel = panel_from_checkpoint(manager, spec, p, seed=seed, step=v1,
                                      device=dev)
        server = EffectServer(panel, wave_sizes=(8, 64), max_queue=256)
        burst_X = data.X[:128].cpu().numpy()
        burst_sids = sids[:128].cpu().numpy()
        r1 = server.score(burst_X, burst_sids)
        print(f"served {len(r1)} requests on v{r1[0].version}: "
              f"first CATE {r1[0].cate:+.4f} "
              f"[{r1[0].lo:+.4f}, {r1[0].hi:+.4f}]")

        # --- day 2 arrives: ingest, snapshot, hot-swap -----------------
        store.ingest(**day(n_day, 2 * n_day))
        v2 = store.save(manager)
        server.swap(panel_from_checkpoint(manager, spec, p, seed=seed,
                                          step=v2, store=store))
        r2 = server.score(burst_X, burst_sids)
        print(f"hot-swapped to v{r2[0].version}: "
              f"first CATE {r2[0].cate:+.4f} "
              f"(moved {r2[0].cate - r1[0].cate:+.5f} with day 2's rows)")

        # --- rollback: one reference assignment ------------------------
        server.rollback()
        r3 = server.score(burst_X[:8], burst_sids[:8])
        print(f"rolled back to v{r3[0].version}: "
              f"first CATE {r3[0].cate:+.4f} "
              f"(bitwise v1 again: {r3[0].cate == r1[0].cate})")

        # --- the per-server latency metrics ----------------------------
        snap = server.snapshot()
        lat = snap["histograms"]["serve.request_seconds"]
        occ = snap["histograms"]["serve.batch_occupancy"]
        print(f"requests={snap['counters']['serve.requests']} "
              f"waves={snap['counters']['serve.waves']} "
              f"p50={lat['p50'] * 1e6:.0f}us p99={lat['p99'] * 1e6:.0f}us "
              f"mean_occupancy={occ['mean']:.2f}")


if __name__ == "__main__":
    main()
