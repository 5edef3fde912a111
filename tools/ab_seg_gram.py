#!/usr/bin/env python3
"""The seg_gram and flash-attention kernels of two checkouts on one
card, in turns.

    python3 tools/ab_seg_gram.py PARENT_TREE [CHANGE_TREE] [--pairs 1]

Each tree is the root of a checkout (``git archive`` of a commit,
unpacked into a directory ``.gitignore`` lists; CHANGE_TREE defaults to
this one).  For every pair the script runs parent, change, change,
parent, each in a process of its own that imports that tree's
``chip_smoke`` and times, with CUDA events and the L2 flushed
(``chip_smoke.Timer``, 3 runs after a warm-up; 10 for flash):

  * seg_gram's main-path forms from ``kernel_cases``
    (``paper_demo_data(n=1_000_000, p=500)``, k = 5 folds) — design,
    design_segmented, gram_and_vec, residual;
  * the bootstrap's fold_weighted from ``inference_cases``
    (``paper_demo_data(n=100_000, p=500)``, R·k = 125);
  * the store's seeded walks (e) ng (503 wide) and (f) vg (1006 wide):
    a day of 2^18 rows into 320 cells, seeded with the tree's own
    Grams of a first day (``chip_smoke.pair_cases``' inputs, built here
    so that both trees see the same ones);
  * flash attention at the backbone's shape (q (256, 256, 32, 64), k/v
    8 heads, bf16, causal).

It prints one JSON line per run and exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FORMS = ("design", "design_segmented", "gram_and_vec", "residual")
SEED = 123


def time_tree(root: str) -> dict:
    """ms per form of ``root``'s kernels (run inside the child process)."""
    sys.path[:0] = [root, str(Path(root) / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.kernels.flash_attention import kernel as fa

    timer = cs.Timer()
    d = paper_demo_data(n=1_000_000, p=500, seed=SEED)
    folds = fold_ids(torch.Generator().manual_seed(SEED), d.n, 5,
                     device="cuda")
    out = {c.name: timer.ms(c.kernel, 3)
           for c in cs.kernel_cases(d.X, d.y, d.t, folds, 5)
           if c.name in FORMS}
    del d, folds
    b = paper_demo_data(n=cs.BOOT_N, p=500, seed=SEED)
    out.update({c.name: timer.ms(c.kernel, 3)
                for c in cs.inference_cases(b.X, b.y, b.t, SEED,
                                            cs.BOOT_CHUNK, 5)
                if c.name == "fold_weighted"})
    del b
    out.update(time_store(timer))
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((cs.BACKBONE_BATCH, cs.BACKBONE_SEQ, h, 64),
                           generator=g, device="cuda").to(torch.bfloat16)
               for h in (32, 8, 8))
    out["flash_attention"] = timer.ms(
        lambda: fa.flash_attention_cuda(q, k, v), 10)
    return out


def time_store(timer) -> dict:
    """ms of the store's two seeded walks, each seeded with the tree's
    own Grams of a first day."""
    import torch

    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nd, p, S = 2 ** 18, 500, 320
    dn = torch.cat([torch.randn((nd, p), generator=g, device="cuda"),
                    torch.ones((nd, 1), device="cuda"),
                    torch.randn((nd, 2), generator=g, device="cuda")], 1)
    phi = torch.cat([torch.ones((nd, 1), device="cuda"), dn[:, :1]], 1)
    v = (phi[:, :, None] * dn[:, None, :]).reshape(nd, -1)
    seg = torch.randint(0, S, (nd,), generator=g, device="cuda")
    out = {}
    for name, M in (("pair:ng", dn), ("pair:vg", v)):
        init = kern.seg_walk_cuda("pair", M, Y=M, seg=seg, n_segments=S)
        out[name] = timer.ms(lambda: kern.seg_walk_cuda(
            "pair", M, Y=M, seg=seg, n_segments=S, init=init), 3)
        del init
    return out


def main(argv=None) -> int:
    """Parent, change, change, parent per pair; one JSON line per run."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_seg_gram: no CUDA device", file=sys.stderr)
        return 2
    if args.time:
        print(json.dumps({"tree": args.parent, "ms": time_tree(args.parent)}))
        return 0
    for _ in range(args.pairs):
        for tree, side in ((args.parent, "parent"), (args.change, "change"),
                           (args.change, "change"), (args.parent, "parent")):
            out = subprocess.run([sys.executable, __file__, "--time",
                                  str(Path(tree).resolve())],
                                 capture_output=True, text=True, check=True)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
