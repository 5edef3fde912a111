#!/usr/bin/env python3
"""Where one LM train step on a one-rank host mesh parts from the same
step with no mesh: the loss, the global gradient norm and each
parameter's gradient, from the same init and batch.

    python3 tools/mesh_drift.py [--device cuda] [--arch granite-3-2b]
                                [--layers 2] [--batch 8] [--seq 256]

The mesh run is ``launch/train.loss_and_grads`` under
``make_host_mesh()`` (one rank: NCCL on the card, gloo on the CPU),
``default_rules(fsdp=False)``, the state placed by
``launch/elastic.state_shardings`` and the batch by
``data/pipeline.batch_sharding`` — what the train CLI runs.  On the
card attention takes the flash kernel; ``--device cpu`` takes the
``-smoke`` config and dense attention.  One rank holds every shard
whole, so where the two runs part is DTensor's own decomposition of an
op, not a split of the data.  Prints one JSON object: both losses and
norms, how many gradient leaves are bitwise, and the six leaves that
part most (max |a - b| / max |a|).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import lm_batch, step_generator
    from repro_torch.data.pipeline import batch_sharding
    from repro_torch.distributed.sharding import (default_rules, distribute,
                                                  dtensor_ops, mesh_context)
    from repro_torch.launch.elastic import state_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (init_state, loss_and_grads,
                                          place_state)
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import global_norm

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    arch = args.arch if cuda else args.arch + "-smoke"
    cfg = dataclasses.replace(get_config(arch), num_layers=args.layers)
    pc = ParallelConfig(fsdp=False, use_flash_attention=cuda)
    rules = default_rules(fsdp=False)
    batch = {k: v.to(args.device) for k, v in lm_batch(
        step_generator(args.seed, 0), args.batch, args.seq,
        cfg.vocab_size).items()}

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    try:
        model = Model(cfg, pc, rules, device=args.device, seed=args.seed)
        met0, g0 = loss_and_grads(model, init_state(model).params, batch)
        n0 = float(global_norm(dict(g0)))
        mesh = make_host_mesh()
        state = place_state(init_state(model),
                            state_shardings(model, rules, mesh))
        with mesh_context(mesh), dtensor_ops():
            placed = {k: distribute(v, batch_sharding(mesh))
                      for k, v in batch.items()}
            met1, g1 = loss_and_grads(model, state.params, placed)
            n1 = float(whole(global_norm(dict(g1))))
        parted = {}
        for k, a in g0.items():
            b = whole(g1[k])
            if not torch.equal(a, b):
                a, b = a.float(), b.float()
                parted[k] = float((a - b).abs().max()
                                  / a.abs().max().clamp(min=1e-30))
    finally:
        dist.destroy_process_group()
    card = None
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({
        "arch": arch, "layers": args.layers, "batch": args.batch,
        "seq": args.seq, "device": args.device, "card": card,
        "torch": torch.__version__,
        "loss": [float(met0["loss"]), float(whole(met1["loss"]))],
        "grad_norm": [n0, n1], "leaves": len(g0),
        "bitwise_leaves": len(g0) - len(parted),
        "most_parted": sorted(parted.items(), key=lambda kv: -kv[1])[:6]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
