#!/usr/bin/env python3
"""How far a backbone's hidden states through the kernels drift from the
same model through the plain versions, layer by layer, on the card.

    python3 tools/feature_drift.py [--arch zamba2-1.2b] [--users 64]
                                   [--seq 256] [--fp32]

Builds the backbone at full width and depth (port init from ``--seed``)
and walks its blocks in order with two hidden streams: one through the
hand-written kernels (flash attention, GLA, SSD), one through their
plain versions.  After each block it prints

  * ``stream``: max|h_kernel - h_plain| / max|h_plain| of the two
    streams (what the features gate of chip_smoke.py sees at the end);
  * ``local``: the same block applied to the plain stream's input
    through the kernel and through the plain version — the error that
    block adds by itself;
  * ``max|h|``: the plain stream's largest activation.

A ``local`` error that stays at the kernel's own level while ``stream``
grows layer by layer is amplification by the model; a ``local`` jump is
a fault of that block's kernel path.  ``--fp32`` runs the compute dtype
in fp32 instead of bf16.  The last line is one JSON object with both
series.  Exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    """Walk the blocks; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--users", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("feature_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.data.event_dgp import make_event_data
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.model import Model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = get_config(args.arch)
    if args.fp32:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    model = Model(cfg, ParallelConfig(use_flash_attention=True),
                  seed=args.seed)
    tokens = make_event_data(args.users, args.seq, cfg.vocab_size,
                             seed=args.seed).tokens
    kernels = (fa_ops.flash_attention, sops.gla, sops.ssd)

    def fa_plain(q, k, v, chunk=None, **kw):
        return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), **kw).transpose(1, 2)

    plain = (fa_plain,
             lambda *a, chunk: sref.gla_chunked_ref(*a, chunk=chunk),
             lambda *a, chunk: sref.ssd_chunked_ref(*a, chunk=chunk))

    def use(fns):
        fa_ops.flash_attention, sops.gla, sops.ssd = fns

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    blocks = list(model.decoder_stack.layers(model.stack))
    series = []
    with torch.no_grad():
        hk = hp = embed_tokens(model.embed, cfg, tokens)
        for name, fn, p in blocks:
            use(plain)
            nxt_p = fn(p, hp)
            use(kernels)
            local = rel(fn(p, hp), nxt_p)
            hk = fn(p, hk)
            hp = nxt_p
            row = {"block": name, "stream": rel(hk, hp), "local": local,
                   "max_abs": float(hp.abs().max())}
            series.append(row)
            print(f"{name:12s} stream {row['stream']:.3e} local "
                  f"{row['local']:.3e} max|h| {row['max_abs']:.3e}",
                  flush=True)
        fk = model.norm(model.ln_f, hk).mean(1).float()
        fp = model.norm(model.ln_f, hp).mean(1).float()
    use(kernels)
    print(f"features kernel-vs-plain {rel(fk, fp):.3e}")
    print(json.dumps({"card": card, "arch": cfg.name,
                      "compute": str(cfg.compute_dtype), "users": args.users,
                      "seq": args.seq, "features": rel(fk, fp),
                      "blocks": series}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
