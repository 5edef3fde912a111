#!/usr/bin/env python3
"""Whether two checkouts compute the same bits outside a mesh: a SHA-256
of a CPU forward and of one train step of every model family's ``-smoke``
configuration, tree by tree.

    python3 tools/ab_forward.py PARENT_TREE [CHANGE_TREE]

Each tree is the root of a checkout (``git archive`` of a commit,
unpacked into a directory ``.gitignore`` lists; CHANGE_TREE defaults to
this one).  The script runs parent, change, change, parent, each in a
process of its own that imports that tree's ``repro_torch`` (one CPU
thread) and, for granite-3-2b (dense), pixtral-12b (vlm), arctic-480b
and deepseek-v3-671b (moe; deepseek with its MTP loss), rwkv6-3b (ssm),
zamba2-1.2b (hybrid) and whisper-tiny (encoder-decoder), each at its
``-smoke`` size in fp32 from seed 0, hashes:

  * ``<arch>:prefill`` — ``Model.prefill``'s last logits and its cache;
  * ``<arch>:decode`` — two ``decode_step``s after it;
  * ``<arch>:step`` — every parameter and AdamW moment after one
    ``launch/train.make_train_step`` step (chunked attention, remat
    "nothing", 2 microbatches) on a seeded batch.

It prints one JSON line per run, then ``{"bitwise": {result: true |
false}}``: whether every run of both trees gave the same bytes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ARCHS = ("granite-3-2b", "pixtral-12b", "arctic-480b", "deepseek-v3-671b",
         "rwkv6-3b", "zamba2-1.2b", "whisper-tiny")
B, S, SEED = 2, 16, 0


def run_tree(tree: str) -> dict:
    """Every hash of this process's tree (its ``src`` first on the path)."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import dataclasses

    import torch
    torch.set_num_threads(1)
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import Model

    h = hashlib.sha256
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch + "-smoke")
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
        pc = ParallelConfig(attention_impl="chunked", attention_chunk=8,
                            remat_policy="nothing", microbatch=2)
        gen = torch.Generator().manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        extras = {}
        if cfg.is_encdec:
            extras["frames"] = torch.randn(
                (B, cfg.max_source_positions, cfg.d_model), generator=gen)
        if cfg.family == "vlm":
            extras["patch_embeds"] = torch.randn((B, 4, cfg.d_model),
                                                 generator=gen)
        model = Model(cfg, pc, device="cpu", seed=SEED)
        logits, cache = model.prefill(tokens, **extras)
        flat = [logits] + _leaves(cache)
        out[f"{arch}:prefill"] = _sha(h, flat)
        full = _grow(model, cache, cfg, B, S + 2)
        steps = []
        for i in range(2):
            lg, full = model.decode_step(tokens[:, i:i + 1], full, S + i)
            steps.append(lg)
        out[f"{arch}:decode"] = _sha(h, steps + _leaves(full))
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
                 **extras}
        state = init_state(model)
        step = make_train_step(model, TrainConfig(warmup_steps=1,
                                                  total_steps=4))
        params, opt, met = step(state.params, state.opt, batch)
        out[f"{arch}:step"] = _sha(
            h, [params[k] for k in sorted(params)]
            + [opt[m][k] for m in ("m", "v") for k in sorted(opt[m])]
            + [met["loss"], met["grad_norm"]])
    return out


def _grow(model, cache, cfg, b, s):
    """The prefill's cache copied into a zero cache of ``s`` positions
    (the recurrent states as they are)."""
    big = model.init_cache(b, s)

    def put(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k])
        elif dst.dim() >= 3 and dst.shape[2] == s and src.shape[2] != s:
            dst[:, :, :src.shape[2]] = src
        else:
            dst.copy_(src)
    if cfg.is_encdec:
        put(big["self"], cache["self"])
        big["cross"] = cache["cross"]
    else:
        put(big, cache)
    return big


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _sha(h, tensors) -> str:
    d = h()
    for t in tensors:
        d.update(t.detach().contiguous().numpy().tobytes())
    return d.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run_tree(args.parent)))
        return 0
    runs = []
    for tree in (args.parent, args.change, args.change, args.parent):
        res = subprocess.run([sys.executable, __file__, tree, "--run"],
                             capture_output=True, text=True, check=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "sha256": line}), flush=True)
        runs.append(line)
    keys = sorted(runs[0])
    print(json.dumps({"bitwise": {k: len({r.get(k) for r in runs}) == 1
                                  for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
