#!/usr/bin/env python3
"""Where a scan kernel's time goes, stage by stage, on the card.

    python3 tools/scan_stages.py [TREE] [--kernels generic|tiled]
                                 [--reps 10]

TREE is the root of a checkout (default: this one).  The script copies
that tree's ``csrc/ssm_scan.cu`` under ``TREE/build/scan_stages/`` once
per stage level k, and in copy k lets only the first k stages of every
chunk run (each later stage is wrapped in ``if (SCAN_STAGE >= n)``; the
program's own source is not touched).  It builds the copies in parallel,
points ``kernel.SOURCE`` at each in turn and times, with CUDA events and
the L2 flushed (``chip_smoke.Timer``), the GLA scan in bonus and post
mode at rwkv6-3b's main-path shape (B 256 × H 40 × T 256 × 64, bf16
r/k/v as strided (B, T, H, D) views, chunk 16) and the SSD scan at
zamba2-1.2b's (B 256 × H 64 × T 256, N = P = 64, fp32, chunk 32).  The
time a stage adds is level k's time less level k − 1's.

``--kernels generic`` splits the generic (first-design) kernels
(``gla_kernel``, ``ssd_kernel``): stages loads, log + cumsum, exp
factors, scores / M, P v / M v, Qt S / q S, state update.  ``--kernels
tiled`` splits the tiled kernels (``gla_kernel_tiled``,
``ssd_kernel_tiled``) at their ``// [stage n: ...]`` comments.  The
launch goes through ``kernel.gla_cuda`` / ``kernel.ssd_cuda`` with
``form=`` set where the tree's wrappers take it (a tree from before the
tiled forms has only the generic kernels).

Prints the card's name and power limit, one JSON line per kernel
(``{"kernel": ..., "ms": {level: ms}, "stages": {name: ms}}``) and exits
2 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

REL = Path("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu")

# (level, old text, new text) of the first-design kernels
GENERIC = [
    # loads (w kept raw below level 2, so the log is level 2's)
    (1, "    for (int e = tid; e < C * Dk; e += NT) {\n"
        "      const int r = e / Dk, d = e % Dk;", None),
    (2, "logf(fmaxf(wb[t * a.sw.t + d], 1e-22f))",
        "(SCAN_STAGE >= 2 ? logf(fmaxf(wb[t * a.sw.t + d], 1e-22f))"
        " : wb[t * a.sw.t + d])"),
    (1, "    for (int e = tid; e < C * Dv; e += NT) {\n"
        "      const int r = e / Dv, j = e % Dv;", None),
    (2, "    for (int d = tid; d < Dk; d += NT) {\n      float cum = 0.f;",
     None),
    (3, "    for (int e = tid; e < C * Dk; e += NT) {\n"
        "      const int i = (e / Dk) * LK + e % Dk;", None),
    (4, "    for (int e = tid; e < C * C; e += NT) {\n"
        "      const int t = e / C, s = e % C;", None),
    (5, "    for (int e = tid; e < C * Dv; e += NT) {\n"
        "      const int t = e / Dv, j = e % Dv;", None),
    (6, "      for (int d = 0; d < Dk; ++d) inter = fmaf(qr[d], S[d * Dv + j],"
        " inter);", None),
    (7, "    for (int e = tid; e < Dk * Dv; e += NT) {\n"
        "      const int d = e / Dv, j = e % Dv;\n      float acc = 0.f;", None),
    # SSD: loads, log + cumsum + flow, M, M v, q S, state
    (1, "    for (int e = tid; e < C * N; e += NT) {\n"
        "      const int r = e / N, n = e % N;", None),
    (1, "    for (int e = tid; e < C * P; e += NT) {\n"
        "      const int r = e / P, j = e % P;\n      V[e] = vb", None),
    (2, "logf(fmaxf(ab[(long long)(c0 + r) * a.sa.t], 1e-37f))",
        "(SCAN_STAGE >= 2 ? logf(fmaxf(ab[(long long)(c0 + r) * a.sa.t],"
        " 1e-37f)) : ab[(long long)(c0 + r) * a.sa.t])"),
    (2, "    if (tid == 0) {\n      float c = 0.f;", None),
    (2, "    for (int r = tid; r < C; r += NT) flow[r]", None),
    (3, "    for (int e = tid; e < C * C; e += NT) {\n"
        "      const int i = e / C, j = e % C;", None),
    (4, "    for (int e = tid; e < C * P; e += NT) {\n"
        "      const int i = e / P, j = e % P;", None),
    (5, "      for (int n = 0; n < N; ++n) inter = fmaf(qr[n], S[n * P + j],"
        " inter);", None),
    (6, "    for (int e = tid; e < N * P; e += NT) {\n"
        "      const int n = e / P, j = e % P;", None),
]
GENERIC_NAMES = {"gla": ["loads", "log + cumsum", "exp factors", "scores",
                         "P v", "Qt S", "state update"],
                 "ssd": ["loads", "log + cumsum + flow", "M", "M v", "q S",
                         "state update"]}


def variant(src: str, level: int, kernels: str) -> str:
    """``src`` with every stage above ``level`` skipped."""
    out = src
    if kernels == "generic":
        for _, old, new in GENERIC:
            if out.count(old) != 1:
                raise ValueError(f"anchor not found once: {old[:60]!r}")
        for n, old, new in GENERIC:
            lead = old[:len(old) - len(old.lstrip(" "))]
            out = out.replace(old, new if new is not None else
                              f"{lead}if (SCAN_STAGE >= {n}) {old.lstrip(' ')}")
    else:
        marks = 0
        for n in range(1, 10):
            tag = f"// [stage {n}:"
            while tag in out:
                i = out.index(tag)
                j = out.index("\n", i)
                out = out[:i] + f"if (SCAN_STAGE >= {n})" + out[j:]
                marks += 1
        if not marks:
            raise ValueError("no '// [stage n: ...]' marks in the source")
    return f"#define SCAN_STAGE {level}\n" + out


def stage_names(src: str, kernels: str):
    """(gla names, ssd names) by level."""
    if kernels == "generic":
        return GENERIC_NAMES["gla"], GENERIC_NAMES["ssd"]
    i, j = src.index("gla_kernel_tiled(GlaArgs"), src.index("ssd_kernel_tiled(SsdArgs")
    out = []
    for part in (src[i:j], src[j:]):
        names = {}
        for line in part.splitlines():
            s = line.strip()
            if s.startswith("// [stage ") and "]" in s:
                n, rest = s[len("// [stage "):].split(":", 1)
                names.setdefault(int(n), rest.split("]")[0].strip())
        if sorted(names) != list(range(1, len(names) + 1)):
            raise ValueError(f"stage marks not numbered 1..n: {sorted(names)}")
        out.append([names[k] for k in sorted(names)])
    return out[0], out[1]


def main(argv=None) -> int:
    """Build every level, time the three scans at each; 0 on success."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernels", choices=("generic", "tiled"),
                    default="generic")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scan_stages: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.ssm_scan import kernel as sk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (root / REL).read_text()
    gla_names, ssd_names = stage_names(src, args.kernels)
    top = max(len(gla_names), len(ssd_names))
    out_dir = root / "build" / "scan_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for level in range(top + 1):
        p = out_dir / f"ssm_scan_{args.kernels}_s{level}.cu"
        p.write_text(variant(src, level, args.kernels))
        paths.append(p)
    from repro_torch.kernels import build
    threads = [threading.Thread(target=build.load_library, args=(p,))
               for p in paths]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    g = torch.Generator(device="cuda").manual_seed(7)
    B, T, D = cs.BACKBONE_BATCH, cs.BACKBONE_SEQ, 64

    def bthd(H, lo=None, dt=torch.float32):
        x = torch.rand((B, T, H, D), generator=g, device="cuda")
        x = x * (1 - lo) + lo if lo is not None else x * 2 - 1
        return x.to(dt).transpose(1, 2)

    wmin = float(torch.exp(torch.tensor(-3.49)))
    bf = torch.bfloat16
    q, k, v = (bthd(40, dt=bf) for _ in range(3))
    w, u = bthd(40, lo=wmin), torch.randn((40, D), generator=g,
                                           device="cuda")
    sq, sk_ = (torch.randn((B, T, D), generator=g, device="cuda")
               for _ in range(2))
    sv = torch.randn((B, T, 64, D), generator=g, device="cuda").transpose(1, 2)
    sa = (torch.rand((B, T, 64), generator=g, device="cuda") * 0.999
          + 1e-3).transpose(1, 2)
    form = ({"form": args.kernels} if hasattr(sk, "FORMS") else {})

    def gla(uu):
        return sk.gla_cuda(q, k, v, w, uu, chunk=16, **form)

    def ssd():
        return sk.ssd_cuda(sq, sk_, sv, sa, chunk=32, **form)

    timer = cs.Timer()
    runs = {"gla[bonus]": lambda: gla(u), "gla[post]": lambda: gla(None),
            "ssd": ssd}
    ms = {name: {} for name in runs}
    for level, p in enumerate(paths):
        sk.SOURCE = p
        for name, fn in runs.items():
            ms[name][level] = timer.ms(fn, args.reps)
    for name in runs:
        names = ssd_names if name == "ssd" else gla_names
        levels = ms[name]
        stages = {"(launch, S init and store)": levels[0]}
        for i, nm in enumerate(names, start=1):
            stages[nm] = levels[i] - levels[i - 1]
        print(json.dumps({"kernel": name, "kernels": args.kernels,
                          "ms": levels, "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
