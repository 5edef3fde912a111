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

    python3 tools/profile_backbone.py --train [--arch ...] [--batch 8]
                                      [--seq 1024]

profiles one ``launch/train.make_train_step`` step (remat "nothing",
fp32 masters and moments, TRAIN_MICRO microbatches as chip_smoke's
``lm_train`` phases take, after one warm step) instead, and also the
time of the plain backwards inside it — the scans' ``gla_bwd_chunks`` /
``ssd_bwd_chunks`` and flash's ``flash_attention_bwd_blocks``, which
the classes above spread over "gemm" and "other" — as the time between
CUDA events recorded around each call, summed: the device's time for
the call with the gaps the host leaves in it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

TRAIN_MICRO = 2         # microbatches of a train step (chip_smoke's lm_train)


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
    ap.add_argument("--batch", type=int, default=None,
                    help="rows (256; 8 with --train)")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a row (256; 1024 with --train)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--serve", action="store_true",
                    help="profile a prefill and decode steps instead")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 8 if args.train else 256
    if args.seq is None:
        args.seq = 1024 if args.train else 256
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
    if args.train:
        return _train(args, cfg, card)
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


class _EventTimes:
    """Wrap ``mod.name`` so that each call records CUDA events around
    itself on the current stream; ``ms()`` sums them after a sync."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.pairs = []

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.fn(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            return out
        setattr(mod, name, timed)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)

    def restore(self) -> None:
        setattr(self.mod, self.name, self.fn)


def _train(args, cfg, card: str) -> int:
    """Profile one train step of ``cfg``; see the module docstring."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.data.lm_data import lm_batch, step_generator
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import Model

    B, S = args.batch, args.seq
    model = Model(cfg, ParallelConfig(use_flash_attention=True,
                                      remat_policy="nothing",
                                      microbatch=TRAIN_MICRO),
                  seed=args.seed)
    state = init_state(model)
    step = make_train_step(model, TrainConfig(learning_rate=1e-3,
                                              warmup_steps=1, total_steps=3))

    def batch(i):
        b = lm_batch(step_generator(args.seed, i), B, S, cfg.vocab_size)
        if cfg.is_encdec:
            b["frames"] = 0.1 * torch.randn(
                (B, cfg.max_source_positions, cfg.d_model),
                generator=step_generator(args.seed, i))
        return {k: v.cuda() for k, v in b.items()}

    def run(b):
        state.params, state.opt, _ = step(state.params, state.opt, b)

    run(batch(0))                               # warm-up
    torch.cuda.synchronize()
    b1 = batch(1)
    timers = {n: _EventTimes(m, n) for m, n in (
        (sops, "gla_bwd_chunks"), (sops, "ssd_bwd_chunks"),
        (fa_ops, "flash_attention_bwd_blocks"))}
    try:
        wall, by = _profile(lambda: run(b1))
        plain = {n: t.ms() for n, t in timers.items()}
        calls = {n: len(t.pairs) for n, t in timers.items()}
    finally:
        for t in timers.values():
            t.restore()
    out = {"card": card, "arch": cfg.name, "batch": B, "seq": S,
           "microbatch": TRAIN_MICRO,
           "step": _report(f"a train step ({B} x {S} tokens, "
                           f"{TRAIN_MICRO} microbatches)", wall, by),
           "plain_backward_ms": plain, "plain_backward_calls": calls,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    for n, ms in plain.items():
        if calls[n]:
            print(f"{n:28s} {ms:10.3f} ms device over {calls[n]} calls "
                  f"({100 * ms / wall:.1f} % of the step's host clock)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
