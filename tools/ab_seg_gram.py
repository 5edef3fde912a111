#!/usr/bin/env python3
"""The seg_gram kernel of two checkouts on one card, in turns.

    python3 tools/ab_seg_gram.py PARENT_TREE [CHANGE_TREE] [--pairs 1]

Each tree is the root of a checkout (``git archive`` of a commit,
unpacked into a directory ``.gitignore`` lists; CHANGE_TREE defaults to
this one).  For every pair the script runs parent, change, change,
parent, each in a process of its own that imports that tree's
``chip_smoke.kernel_cases`` (``paper_demo_data(n=1_000_000, p=500)``,
k = 5 folds) and times the kernel of its main-path forms — design,
design_segmented, gram_and_vec, residual — with CUDA events, the L2
flushed (``chip_smoke.Timer``, 3 runs after a warm-up).  It prints one
JSON line per run and exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FORMS = ("design", "design_segmented", "gram_and_vec", "residual")


def time_tree(root: str) -> dict:
    """ms per form of ``root``'s kernel (run inside the child process)."""
    sys.path[:0] = [root, str(Path(root) / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=1_000_000, p=500, seed=123)
    folds = fold_ids(torch.Generator().manual_seed(123), d.n, 5,
                     device="cuda")
    timer = cs.Timer()
    return {c.name: timer.ms(c.kernel, 3)
            for c in cs.kernel_cases(d.X, d.y, d.t, folds, 5)
            if c.name in FORMS}


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
