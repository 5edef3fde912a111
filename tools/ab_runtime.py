#!/usr/bin/env python3
"""The happy path of two checkouts on one card, in turns, with a SHA-256
of every result — whether moving replicate inference and cross-fitting
onto the task runtime changed any bits.

    python3 tools/ab_runtime.py PARENT_TREE [CHANGE_TREE] [--pairs 1]
                                [--boot-b 26]

Each tree is the root of a checkout (``git archive`` of a commit,
unpacked into a directory ``.gitignore`` lists; CHANGE_TREE defaults to
this one).  For every pair the script runs parent, change, change,
parent, each in a process of its own that imports that tree's
``repro_torch`` and computes, on data made from seed 123:

  * ``dml:theta`` / ``dml:jackknife`` — ``DML.fit`` on the tables cell
    (``paper_demo_data(1_000_000, 500)``, k 5, ridge + logistic, basis
    [1, x0], the "parallel" engine, row_block 65536, "pallas") and its
    delete-fold jackknife's thetas;
  * ``orthoiv:jackknife`` — OrthoIV's jackknife thetas on
    ``make_iv_data(1_000_000, 500)`` at the same configuration;
  * ``<estimator>:bootstrap`` — the pairs-bootstrap replicates of DML,
    DRLearner (``paper_demo_data(100_000, 500)``), OrthoIV and DRIV
    (``make_iv_data(100_000, 500)``) at ``runtime_chunk=25``, B =
    ``--boot-b`` (26: a full chunk and a remainder).

It prints one JSON line per run (``sha256`` and host ``seconds`` per
result, synchronized), then ``{"bitwise": {result: true | false}}``:
whether every run of both trees gave the same bytes.  It exits 2
without CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 123


def sha(t) -> str:
    """SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def run_tree(tree: str, boot_b: int) -> dict:
    """Every result of this process's tree (its ``src`` first on the
    path)."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.core.drlearner import DRLearner
    from repro_torch.core.iv import DRIV, OrthoIV
    from repro_torch.data.causal_dgp import make_iv_data, paper_demo_data

    base = CausalConfig(n_folds=5, nuisance_y="ridge", nuisance_t="logistic",
                        cate_features=2, engine="parallel",
                        inference="jackknife", row_block=65536,
                        row_block_strategy="pallas")
    boot = dataclasses.replace(base, inference="bootstrap",
                               n_bootstrap=boot_b, runtime_chunk=25)
    shas, secs = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        shas[name] = sha(out)

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    data = paper_demo_data(n=1_000_000, p=500, seed=SEED)
    res = None

    def fit():
        nonlocal res
        res = DML(base).fit(data.y, data.t, data.X, gen=gen())
        return res.theta

    timed("dml:theta", fit)
    timed("dml:jackknife", lambda: res.inference().replicates)
    del data, res
    iv = make_iv_data(n=1_000_000, p=500, seed=SEED)
    timed("orthoiv:jackknife", lambda: OrthoIV(base).fit(
        iv.y, iv.t, iv.z, iv.X, gen=gen()).inference().replicates)
    del iv
    torch.cuda.empty_cache()
    bd = paper_demo_data(n=100_000, p=500, seed=SEED)
    timed("dml:bootstrap", lambda: DML(boot).fit(
        bd.y, bd.t, bd.X, gen=gen()).inference().replicates)
    timed("drlearner:bootstrap", lambda: DRLearner(boot).fit(
        bd.y, bd.t, bd.X, gen=gen()).inference().replicates)
    del bd
    ib = make_iv_data(n=100_000, p=500, seed=SEED)
    timed("orthoiv:bootstrap", lambda: OrthoIV(boot).fit(
        ib.y, ib.t, ib.z, ib.X, gen=gen()).inference().replicates)
    timed("driv:bootstrap", lambda: DRIV(boot).fit(
        ib.y, ib.t, ib.z, ib.X, gen=gen()).inference().replicates)
    return {"sha256": shas, "seconds": secs}


def main(argv=None) -> int:
    """Parent, change, change, parent per pair; one JSON line per run,
    then whether each result's bytes agree across every run."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--boot-b", type=int, default=26)
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_runtime: no CUDA device", file=sys.stderr)
        return 2
    if args.run:
        print(json.dumps({"tree": args.parent,
                          **run_tree(args.parent, args.boot_b)}))
        return 0
    digests = {}
    for _ in range(args.pairs):
        for tree, side in ((args.parent, "parent"), (args.change, "change"),
                           (args.change, "change"), (args.parent, "parent")):
            out = subprocess.run([sys.executable, __file__, "--run",
                                  "--boot-b", str(args.boot_b),
                                  str(Path(tree).resolve())],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr, file=sys.stderr)
                out.check_returncode()
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **rec}), flush=True)
            for name, h in rec["sha256"].items():
                digests.setdefault(name, set()).add(h)
    print(json.dumps({"bitwise": {k: len(h) == 1
                                  for k, h in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
