#!/usr/bin/env python3
"""The seg_gram, flash-attention and scan kernels of two checkouts on
one card, in turns, with a SHA-256 of every output.

    python3 tools/ab_seg_gram.py PARENT_TREE [CHANGE_TREE] [--pairs 1]
                                 [--forms all|thin-small|big|scans|flash]

Each tree is the root of a checkout (``git archive`` of a commit,
unpacked into a directory ``.gitignore`` lists; CHANGE_TREE defaults to
this one).  For every pair the script runs parent, change, change,
parent, each in a process of its own that imports that tree's
``repro_torch`` (and, for the large forms, its ``chip_smoke``) and
times, with CUDA events and the L2 flushed (``chip_smoke.Timer``, 3
runs after a warm-up; 10 for the small forms and flash):

  * ``thin-small``: the thin and small tile forms at chip_smoke's shapes,
    on inputs made here from one seed, so both trees see the same ones —
    the sweep's MM terms pair:t1 (2^20 × 5 by 2^20 × 501, S = 64) and
    pair:t2 (1 × 501, S = 320), its final stage pair:final (2 × 2,
    S = 64) and pair:final@rb, the same call with ``row_block=65536``
    where the tree's ``segment_outer`` takes it; OrthoIV's iv, iv_meat and iv_segmented (S = 5) at n = 1M,
    phi 2 wide; the final stage's residual, residual_meat and
    residual_gram at n = 1M; the bootstrap's residual_direct and
    residual_meat at n = 100k, R = 25.  ``ms`` times the eager call,
    the host's Python included (which outlasts the L2 flush for the
    small forms); ``ms_graph`` its launches replayed from a CUDA graph,
    the device's time.  Where the tree caches walk plans, ``ms`` clears
    the cache before each run (as a tree without it plans on every
    launch) and ``ms_warm`` keeps the plan; ``split`` gives plan (eager)
    / tile kernel / second pass (graphs) apart (``kernel.walk_plan`` and
    ``kernel.stage``) where the tree has them;
  * ``big``: seg_gram's large-tile forms from ``kernel_cases``
    (``paper_demo_data(n=1_000_000, p=500)``, k = 5 folds) — design,
    design_segmented, gram_and_vec —, the bootstrap's fold_weighted
    (``paper_demo_data(n=100_000, p=500)``, R·k = 125), the store's
    seeded walks (e) ng (503 wide) and (f) vg (1006 wide) of a day of
    2^18 rows into 320 cells, seeded with the tree's own Grams of a first
    day (and ``pair:ng@rb`` / ``pair:vg@rb``: the same seeded walks
    through ``segment_outer``, with ``row_block=65536`` where the tree
    takes it; SHA-256 only), and flash attention at the backbone's shape (q (256, 256, 32,
    64), k/v 8 heads, bf16, causal);
  * ``scans``: the GLA scan in bonus and post mode at rwkv6-3b's
    main-path shape (B 256 × H 40 × T 256 × 64, bf16 r/k/v as strided
    (B, T, H, D) views, chunk 16) and the SSD scan at zamba2-1.2b's (B 256
    × H 64 × T 256, N = P = 64, fp32 views, chunk 32), then the small
    cases chip_smoke's scan phase checks: GLA bonus in fp32 (B 4 × H 8 ×
    T 256, chunk 16) and at T = 200 (bf16, the chunk halved to 8), the
    SSD at T = 200 (chunk 8); each through the tree's ``gla_cuda`` /
    ``ssd_cuda`` (the form its shape takes there), with the SHA-256 of o
    and of the final state apart (``<form>:o``, ``<form>:state``);
  * ``flash``: flash attention's square head dims as chip_smoke's
    ``kernels:flash`` runs them — the backbone's shape (q (256, 256, 32,
    64), k/v 8 heads, causal) in bf16 and fp32, fp32 causal at 5 key
    blocks (2 × 320 × 8/2 × 64), bf16 with a softcap of 30 (2 × 192 ×
    8/8 × 64) — and the bf16 and fp32 templates at every square head
    dim (16, 32, 64, 128) on ragged, GQA and MQA shapes, causal and
    not, with a softcap, then deepseek-v3's MLA prefill wave (8 × 128,
    128 heads, q.k 192 / v 128) in both templates and whisper-tiny's
    bidirectional encoder wave (8 × 1500 frames, 6 heads × 64, bf16);
    through the tree's ``flash_attention_cuda``, whose call is the same
    in both trees (a launch asking for no LSE).

It prints one JSON line per run (``ms``, ``sha256`` per form; for the
thin and small forms ``ms_graph``, and ``ms_warm`` and ``split`` where
the tree has them), then one line ``{"bitwise": {form: true | false}}``:
whether every run of both trees gave the same bytes.
It exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

BIG_FORMS = ("design", "design_segmented", "gram_and_vec")
SEED = 123


def sha(out) -> str:
    """SHA-256 of the bytes of a tensor or a tuple of tensors."""
    import torch

    outs = out if isinstance(out, (tuple, list)) else (out,)
    flat = torch.cat([o.detach().reshape(-1).float().cpu() for o in outs])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def _row_block(ops) -> dict:
    """``row_block=65536`` where the tree's ``segment_outer`` takes it
    (without a data mesh it must change no bit), else nothing: the
    parent's call is the one without it."""
    import inspect

    params = inspect.signature(ops.segment_outer).parameters
    return {"row_block": 65536} if "row_block" in params else {}


def thin_small_forms():
    """(name, fn, walk) of the thin and small forms; walk is (seg, S, qL,
    qR) for a segment walk, else None."""
    import torch

    from repro_torch.core.moments import design
    from repro_torch.kernels.residual_gram import kernel as rg
    from repro_torch.kernels.seg_gram import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev, E, k = "cuda", 64, 5

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n = 2 ** 20
    Xa = design(rnd(n, 500), intercept=True)                   # (n, 501)
    sids = torch.randint(0, E, (n,), generator=g, device=dev)
    comb = torch.randint(0, E * k, (n,), generator=g, device=dev)
    r, rr, m = rnd(n, k), rnd(n, 1), rnd(n, 2)
    n1 = 1_000_000
    ry, rt, rz, y, t = (rnd(n1) for _ in range(5))
    my, mt = 0.1 * rnd(n1), torch.sigmoid(rnd(n1))
    phi = torch.cat([torch.ones((n1, 1), device=dev), rnd(n1, 1)], 1)
    ones = torch.ones(n1, device=dev)
    theta = torch.tensor([1.0, 0.5], device=dev)
    folds = torch.randint(0, k, (n1,), generator=g, device=dev)
    nb, R = 100_000, 25
    phib = phi[:nb].contiguous()
    ryb, rtb = rnd(R, nb), rnd(R, nb)
    wb = torch.rand((R, nb), generator=g, device=dev)
    zero = torch.zeros_like(ryb)
    thb = theta + 0.01 * rnd(R, 2)
    rb = _row_block(ops)
    return [
        ("pair:t1", lambda: ops.segment_outer(r, Xa, sids, E),
         (sids, E, k, 501)),
        ("pair:t2", lambda: ops.segment_outer(rr, Xa, comb, E * k),
         (comb, E * k, 1, 501)),
        ("pair:final", lambda: ops.segment_outer(m, m, sids, E),
         (sids, E, 2, 2)),
        ("pair:final@rb", lambda: ops.segment_outer(m, m, sids, E, **rb),
         (sids, E, 2, 2)),
        ("iv", lambda: ops.iv_gram(ry, rt, rz, phi, ones)[0], None),
        ("iv_meat", lambda: ops.iv_meat(ry, rt, rz, phi, theta), None),
        ("iv_segmented", lambda: ops.seg_reduce(
            ref.build_iv, [ry[:, None], rt[:, None], rz[:, None], phi],
            seg=folds, n_segments=k), (folds, k, 5, 5)),
        ("residual", lambda: ops.residual_gram(y, t, my, mt, phi), None),
        ("residual_meat", lambda: ops.residual_meat(y, t, my, mt, phi,
                                                    theta), None),
        ("residual_gram", lambda: rg.residual_gram_cuda(y, t, my, mt, phi),
         None),
        ("residual_direct@R25",
         lambda: ops.residual_weighted_gram(ryb, rtb, phib, wb)[0], None),
        ("residual_meat@R25",
         lambda: ops.residual_meat(ryb, rtb, zero, zero, phib, thb, w=wb),
         None),
    ]


def graph_ms(timer, fn, reps):
    """Mean ms of ``fn``'s launches replayed from a CUDA graph (the
    device's time without the host's Python), or None if ``fn`` cannot
    be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        print(f"ab_seg_gram: no graph: {e}", file=sys.stderr)
        return None
    return timer.ms(graph.replay, reps)


def time_thin_small(timer) -> dict:
    """ms (eager; a walk with its plan made anew), ms_warm (a walk with
    its plan cached), ms_graph (the launches replayed from a CUDA graph),
    split and sha256 of the thin and small forms."""
    from repro_torch.kernels.seg_gram import kernel as kern

    cached = hasattr(kern, "clear_plan_cache")
    out = {"ms": {}, "ms_warm": {}, "ms_graph": {}, "split": {},
           "sha256": {}}
    for name, fn, walk in thin_small_forms():
        out["sha256"][name] = sha(fn())
        out["ms_graph"][name] = graph_ms(timer, fn, 10)
        if walk is not None and cached:
            out["ms"][name] = timer.ms(
                lambda: (kern.clear_plan_cache(), fn()), 10)
            out["ms_warm"][name] = timer.ms(fn, 10)
        else:
            out["ms"][name] = timer.ms(fn, 10)
        if hasattr(kern, "stage"):
            split = {}
            for part in ("main", "reduce"):
                with kern.stage(part):
                    split[part] = graph_ms(timer, fn, 10)
            if walk is not None:
                seg, S, qL, qR = walk
                rs = kern.library().seg_gram_split_rows(qL, qR)
                split["plan"] = timer.ms(lambda: kern.walk_plan(seg, S, rs),
                                         10)
                split["design"] = kern.design_of(qL, qR)
            out["split"][name] = split
    return out


def time_big(timer) -> dict:
    """ms and sha256 of the large-tile forms and flash attention."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.crossfit import fold_ids
    from repro_torch.data.causal_dgp import paper_demo_data
    from repro_torch.kernels.flash_attention import kernel as fa

    ms, digest = {}, {}
    d = paper_demo_data(n=1_000_000, p=500, seed=SEED)
    folds = fold_ids(torch.Generator().manual_seed(SEED), d.n, 5,
                     device="cuda")
    for c in cs.kernel_cases(d.X, d.y, d.t, folds, 5):
        if c.name in BIG_FORMS:
            digest[c.name] = sha(c.kernel())
            ms[c.name] = timer.ms(c.kernel, 3)
    del d, folds
    b = paper_demo_data(n=cs.BOOT_N, p=500, seed=SEED)
    for c in cs.inference_cases(b.X, b.y, b.t, SEED, cs.BOOT_CHUNK, 5):
        if c.name == "fold_weighted":
            digest[c.name] = sha(c.kernel())
            ms[c.name] = timer.ms(c.kernel, 3)
    del b
    store_ms, store_sha = time_store(timer)
    ms.update(store_ms)
    digest.update(store_sha)
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((cs.BACKBONE_BATCH, cs.BACKBONE_SEQ, h, 64),
                           generator=g, device="cuda").to(torch.bfloat16)
               for h in (32, 8, 8))
    digest["flash_attention"] = sha(fa.flash_attention_cuda(q, k, v))
    ms["flash_attention"] = timer.ms(
        lambda: fa.flash_attention_cuda(q, k, v), 10)
    return {"ms": ms, "sha256": digest}


def time_store(timer):
    """ms and sha256 of the store's two seeded walks, each seeded with the
    tree's own Grams of a first day."""
    import torch

    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.kernels.seg_gram import ops

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nd, p, S = 2 ** 18, 500, 320
    rb = _row_block(ops)
    dn = torch.cat([torch.randn((nd, p), generator=g, device="cuda"),
                    torch.ones((nd, 1), device="cuda"),
                    torch.randn((nd, 2), generator=g, device="cuda")], 1)
    phi = torch.cat([torch.ones((nd, 1), device="cuda"), dn[:, :1]], 1)
    v = (phi[:, :, None] * dn[:, None, :]).reshape(nd, -1)
    seg = torch.randint(0, S, (nd,), generator=g, device="cuda")
    ms, digest = {}, {}
    for name, M in (("pair:ng", dn), ("pair:vg", v)):
        init = kern.seg_walk_cuda("pair", M, Y=M, seg=seg, n_segments=S)

        def walk():
            return kern.seg_walk_cuda("pair", M, Y=M, seg=seg, n_segments=S,
                                      init=init)

        digest[name] = sha(walk())
        ms[name] = timer.ms(walk, 3)
        # the store's call, through segment_outer with its row_block
        digest[name + "@rb"] = sha(ops.segment_outer(M, M, seg, S, init=init,
                                                     **rb))
        del init
    return ms, digest


def scan_forms():
    """(name, fn) of the scans at the main-path shapes and at chip_smoke's
    small cases, on inputs made here from one seed."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as sk

    g = torch.Generator(device="cuda").manual_seed(SEED)
    wmin = float(torch.exp(torch.tensor(-3.49)))

    def gla_in(B, H, T, dtype):
        def bthd(lo=None):
            x = torch.rand((B, T, H, 64), generator=g, device="cuda")
            x = x * (1 - lo) + lo if lo is not None else x * 2 - 1
            return x.transpose(1, 2)
        q, k, v = (bthd().to(dtype) for _ in range(3))
        return q, k, v, bthd(lo=wmin), torch.randn((H, 64), generator=g,
                                                   device="cuda")

    def ssd_in(B, H, T):
        q, k = (torch.randn((B, T, 64), generator=g, device="cuda")
                for _ in range(2))
        v = torch.randn((B, T, H, 64), generator=g,
                        device="cuda").transpose(1, 2)
        a = (torch.rand((B, T, H), generator=g, device="cuda") * 0.999
             + 1e-3).transpose(1, 2)
        return q, k, v, a

    bf = torch.bfloat16
    main = gla_in(256, 40, 256, bf)
    fp32 = gla_in(4, 8, 256, torch.float32)
    t200 = gla_in(4, 8, 200, bf)
    ssd_main, ssd_200 = ssd_in(256, 64, 256), ssd_in(4, 8, 200)
    return [
        ("gla[bonus]", lambda: sk.gla_cuda(*main, chunk=16)),
        ("gla[post]", lambda: sk.gla_cuda(*main[:4], None, chunk=16)),
        ("ssd", lambda: sk.ssd_cuda(*ssd_main, chunk=32)),
        ("gla[bonus]@fp32", lambda: sk.gla_cuda(*fp32, chunk=16)),
        ("gla[bonus]@T200", lambda: sk.gla_cuda(*t200, chunk=8)),
        ("ssd@T200", lambda: sk.ssd_cuda(*ssd_200, chunk=8)),
    ]


def time_scans(timer) -> dict:
    """ms (10 runs) and the SHA-256 of o and of the state of each scan."""
    ms, digest = {}, {}
    for name, fn in scan_forms():
        o, state = fn()
        digest[name + ":o"], digest[name + ":state"] = sha(o), sha(state)
        ms[name] = timer.ms(fn, 10)
    return {"ms": ms, "sha256": digest}


def flash_forms():
    """(name, fn) of the flash-attention cases (inputs made here from one
    seed, so both trees see the same ones)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def case(B, S, H, KV, D, dtype, causal=True, cap=0.0, Sk=None, Dv=None):
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((B, Sk or S, KV, d), generator=g,
                            device="cuda").to(dtype) for d in (D, Dv or D))
        return lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                               softcap=cap)

    bf, f32 = torch.bfloat16, torch.float32
    out = [("flash:backbone:bf16", case(256, 256, 32, 8, 64, bf)),
           ("flash:backbone:fp32", case(256, 256, 32, 8, 64, f32)),
           ("flash:fp32:5blocks", case(2, 320, 8, 2, 64, f32)),
           ("flash:bf16:softcap30", case(2, 192, 8, 8, 64, bf, cap=30.0))]
    for D in (16, 32, 64, 128):
        for tag, dt in (("bf16", bf), ("fp32", f32)):
            out += [(f"flash:{tag}:D{D}:causal", case(2, 320, 16, 4, D, dt)),
                    (f"flash:{tag}:D{D}:ragged", case(1, 200, 8, 1, D, dt,
                                                      False, 30.0, Sk=320))]
    # deepseek-v3's MLA prefill wave (q.k 192, v 128) and whisper-tiny's
    # bidirectional encoder wave over 1500 frames, as kernels:flash runs them
    out += [("flash:mla:bf16", case(8, 128, 128, 128, 192, bf, Dv=128)),
            ("flash:mla:fp32", case(8, 128, 128, 128, 192, f32, Dv=128)),
            ("flash:bidir1500:bf16", case(8, 1500, 6, 6, 64, bf, False))]
    return out


def time_flash(timer) -> dict:
    """ms (10 runs) and the SHA-256 of o of each flash case."""
    ms, digest = {}, {}
    for name, fn in flash_forms():
        digest[name] = sha(fn())
        ms[name] = timer.ms(fn, 10)
    return {"ms": ms, "sha256": digest}


def time_tree(root: str, forms: str) -> dict:
    """ms and sha256 per form of ``root``'s kernels (run inside the child
    process)."""
    sys.path[:0] = [root, str(Path(root) / "src")]
    import chip_smoke as cs

    timer = cs.Timer()
    out = {"ms": {}, "sha256": {}}
    if forms in ("all", "thin-small"):
        out = time_thin_small(timer)
    if forms in ("all", "big"):
        big = time_big(timer)
        out["ms"].update(big["ms"])
        out["sha256"].update(big["sha256"])
    if forms in ("all", "scans"):
        scans = time_scans(timer)
        out["ms"].update(scans["ms"])
        out["sha256"].update(scans["sha256"])
    if forms in ("all", "flash"):
        flash = time_flash(timer)
        out["ms"].update(flash["ms"])
        out["sha256"].update(flash["sha256"])
    return out


def main(argv=None) -> int:
    """Parent, change, change, parent per pair; one JSON line per run,
    then whether each form's bytes agree across every run."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--forms", choices=("all", "thin-small", "big", "scans",
                                        "flash"),
                    default="all")
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_seg_gram: no CUDA device", file=sys.stderr)
        return 2
    if args.time:
        print(json.dumps({"tree": args.parent,
                          **time_tree(args.parent, args.forms)}))
        return 0
    digests = {}
    for _ in range(args.pairs):
        for tree, side in ((args.parent, "parent"), (args.change, "change"),
                           (args.change, "change"), (args.parent, "parent")):
            out = subprocess.run([sys.executable, __file__, "--time",
                                  "--forms", args.forms,
                                  str(Path(tree).resolve())],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr, file=sys.stderr)
                out.check_returncode()
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **rec}), flush=True)
            for form, h in rec["sha256"].items():
                digests.setdefault(form, set()).add(h)
    print(json.dumps({"bitwise": {f: len(h) == 1
                                  for f, h in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
