#!/usr/bin/env python3
"""How far a backbone's served logits drift from its train path, end to
end, when the model is cut to its first layers.

    python3 tools/serve_drift.py [--arch granite-3-2b] [--layers 4]
                                 [--batch 2] [--prompt 96] [--new 24]
                                 [--frames 1500] [--device cpu]

Builds ``--arch`` at full width with ``--layers`` of its layers (port
init from ``--seed``; the stacked weights rescaled to the std the full
depth's init gives them, 1/sqrt(full layers), so each layer's gains are
the full model's) and a vocabulary of 8192, in its bf16 compute dtype;
an encoder-decoder keeps ``--layers`` of its encoder layers too and
takes ``--frames`` frames a sequence, a vlm ``--prompt`` // 4 patch
embeddings (both 0.1 · normal from the seed).  Then, on ``--batch``
random sequences of ``--prompt`` + ``--new`` tokens, it prints
max|a - b| / max|b| over the rows of

  * ``prefill``: ``Model.prefill``'s last-token logits against the train
    path's logits at that position (the same function, other shapes);
  * ``decode``: teacher-forced ``decode_step`` logits against the train
    path's, the largest over the decoded positions;

the numbers ``chip_smoke.py``'s end-to-end serving tolerance
(``LM_E2E_TOL``) rests on: one-step bf16 differences carried through
the untrained layers into each position's logits.  The last line is one
JSON object.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    """Measure the drift; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=96)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--frames", type=int, default=1500,
                    help="an encoder-decoder's frames a sequence")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("serve_drift: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models.model import Model

    full = get_config(args.arch)
    over = dict(num_layers=args.layers, vocab_size=8192)
    if full.shared_attn_every:
        over["shared_attn_every"] = min(full.shared_attn_every, args.layers)
    if full.is_encdec:
        over.update(encoder_layers=args.layers,
                    max_source_positions=args.frames)
    cfg = dataclasses.replace(full, **over)
    model = Model(cfg, ParallelConfig(use_flash_attention=True),
                  device=args.device, seed=args.seed)
    # the full depth's std for the stacked "scaled" weights (fan-in is the
    # layer axis after stacking, models/params.py); the shared block is
    # not stacked
    with torch.no_grad():
        for name, w in model.named_parameters():
            depth = (full.encoder_layers if name.startswith("encoder.")
                     else full.num_layers)
            if name.startswith(("stack.", "decoder.", "encoder.layers.")) \
                    and "shared_attn" not in name \
                    and w.dim() >= 3 and float(w.std()) > 0:
                w.mul_((args.layers / depth) ** 0.5)
    B, P, N = args.batch, args.prompt, args.new
    toks = torch.randint(0, cfg.vocab_size, (B, P + N),
                         generator=torch.Generator().manual_seed(args.seed)
                         ).to(model.device)

    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    extras = {}
    if cfg.is_encdec:
        extras["frames"] = 0.1 * torch.randn(
            (B, args.frames, cfg.d_model), generator=gen, device=model.device)
    elif cfg.family == "vlm":
        extras["patch_embeds"] = 0.1 * torch.randn(
            (B, max(1, P // 4), cfg.d_model), generator=gen,
            device=model.device)
    extras = {k: v.to(cfg.compute_dtype) for k, v in extras.items()}

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    with torch.no_grad():
        train = model._logits(model._hidden(toks, **extras))
        logits, cache = model.prefill(toks[:, :P], **extras)
        out = {"arch": args.arch, "layers": args.layers,
               "of": full.num_layers, "prefill": rel(logits[:, 0],
                                                     train[:, P - 1])}
        cache = _splice_prefill(model.init_cache(B, P + N), cache, P)
        worst = 0.0
        for t in range(P, P + N):
            logits, cache = model.decode_step(toks[:, t:t + 1], cache, t)
            worst = max(worst, rel(logits[:, 0], train[:, t]))
    out["decode"] = worst
    out["max_logit"] = float(train.float().abs().max())
    print(f"{args.arch} cut to {args.layers} of {full.num_layers} layers on "
          f"{model.device}: prefill vs train {out['prefill']:.4f}, "
          f"teacher-forced decode vs train {worst:.4f} (max |logit| "
          f"{out['max_logit']:.3f})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
