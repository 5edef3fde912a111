#!/usr/bin/env python3
"""Where the backbone's feature time goes on the card: one profiled
forward of ``Model.features`` at chip_smoke.py's backbone shape.

    python3 tools/profile_backbone.py [--arch granite-3-2b] [--batch 256]
                                      [--seq 256]

Builds the backbone (granite-3-2b, rwkv6-3b or zamba2-1.2b) at full
width and depth on the CUDA card (port init from ``--seed``), runs one
warm-up batch, then one batch under ``torch.profiler`` (CPU and CUDA
activities), and prints the device time by kernel class — the
flash-attention kernel, the scan kernels (GLA, SSD), GEMMs (cuBLAS /
CUTLASS), everything else (casts, norms, RoPE, gates, token shift,
conv, gathers) — with
the host-clock time of the same batch and the device's busy share of
it.  The last line is one JSON object with those numbers.  Exits 2
without CUDA.

    python3 tools/profile_backbone.py --serve [--arch ...] [--batch 8]
                                      [--seq 128] [--steps 4]

profiles serving instead: ``Model.prefill`` over ``--batch`` x ``--seq``
tokens, then ``--steps`` ``decode_step`` calls against that cache (after
one warm-up of each), with copies (the per-call weight casts among
them) as a class of their own.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def _klass(name: str) -> str:
    n = name.lower()
    if "fa_fwd_kernel" in n or "fa_bf16_kernel" in n:
        return "flash_attention"
    if "gla_kernel" in n or "ssd_kernel" in n:
        return "scan"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "gemm"
    if "copy" in n:
        return "copy"
    return "other"


def _profile(fn):
    """(host ms, {class: device ms}) of one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = {"flash_attention": 0.0, "scan": 0.0, "gemm": 0.0, "copy": 0.0,
          "other": 0.0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by[_klass(ev.key)] += dev_us / 1e3
    return wall_ms, by


def _report(what: str, wall_ms: float, by: dict) -> dict:
    busy = sum(by.values())
    for k, v in by.items():
        print(f"{k:16s} {v:10.3f} ms device "
              f"({100 * v / busy if busy else 0:.1f} % of device time)")
    print(f"{what}: host clock {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f} %; not measured if 0)", flush=True)
    return {"wall_ms": wall_ms, "device_ms": by,
            "device_busy_share": busy / wall_ms}


def main(argv=None) -> int:
    """Profile one batch; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--serve", action="store_true",
                    help="profile a prefill and decode steps instead")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_backbone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.data.event_dgp import make_event_data
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = get_config(args.arch)
    model = Model(cfg, ParallelConfig(use_flash_attention=True),
                  seed=args.seed)
    tokens = make_event_data(args.batch, args.seq, cfg.vocab_size,
                             seed=args.seed).tokens
    out = {"card": card, "arch": cfg.name, "batch": args.batch,
           "seq": args.seq}
    if not args.serve:
        model.features(tokens)                  # warm-up: build, cuBLAS
        torch.cuda.synchronize()
        out.update(_report(f"one batch ({args.batch} x {args.seq} tokens)",
                           *_profile(lambda: model.features(tokens))))
        print(json.dumps(out))
        return 0
    from repro_torch.launch.serve import _splice_prefill

    S, n = args.seq, args.steps
    nxt = tokens[:, :1]

    def prefilled():
        _, c = model.prefill(tokens)
        return _splice_prefill(model.init_cache(args.batch, S + n + 1), c, S)

    cache = prefilled()
    model.decode_step(nxt, cache, S)            # warm-up of both forms
    torch.cuda.synchronize()
    out["prefill"] = _report(f"prefill ({args.batch} x {S} tokens)",
                             *_profile(lambda: model.prefill(tokens)))
    cache = prefilled()

    def steps():
        for s in range(n):
            model.decode_step(nxt, cache, S + s)
    wall, by = _profile(steps)
    out["decode"] = _report(f"decode, a step of {n} ({args.batch} tokens)",
                            wall / n, {k: v / n for k, v in by.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
