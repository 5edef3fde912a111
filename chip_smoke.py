#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--n 1000000] [--out results.json]

Phases (each failure makes the script exit non-zero):

  1. the card (name and power limit, as nvidia-smi reports them), the
     torch/CUDA versions, and the build of every kernel from source;
  2. every kernel against its plain PyTorch version at the main path's
     shapes: error of each against an fp64 computation, kernel and plain
     times (CUDA events, L2 flushed between runs), one library call
     (``torch.matmul``) timed as a yardstick, and the least time the
     card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
     fp32; a symmetric Gram counts its q(q+1)/2 distinct entries);
  3. the kernel's bitwise invariants on the card;
  4. a small fit on the card against the same fit on the CPU;
  5. the main path at full width — ``paper_demo_data`` then ``DML.fit``
     plus the delete-fold jackknife — on the "parallel", "parallel_loo"
     and row_block=0 paths, each with the launch counters set to 0 just
     before and read just after, the fallback counters held at 0, and
     theta = [1, 0.5] recovered within 5 se (the larger of the jackknife
     and the HC0 sandwich se).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside tensor cores
KERNEL_TOL = 1e-4              # |kernel - plain| / max|plain|
SEG_SRC = "src/repro_torch/kernels/seg_gram/csrc/seg_gram.cu"
SEG_TPU = "src/repro/kernels/seg_gram/kernel.py:57"
RG_TPU = "src/repro/kernels/residual_gram/kernel.py:29"


def log(msg: str) -> None:
    """Print one progress line, flushed."""
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each run."""

    def __init__(self) -> None:
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")           # 256 MB > 50 MB L2

    def ms(self, fn, reps: int, warm: int = 1) -> float:
        """Mean ms of ``fn`` over ``reps`` runs after ``warm`` runs."""
        for _ in range(warm):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / reps


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|, in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@dataclasses.dataclass
class Case:
    """One kernel at one main-path shape, with its plain twin."""

    name: str            # counter key / record name
    form: str            # which main-path form it serves
    kernel: object       # () -> Tensor via the kernel's wrapper
    plain: object        # () -> Tensor, plain PyTorch on the card
    exact: object        # () -> Tensor, fp64
    lib_prep: object     # () -> operands of the library call (untimed)
    lib: object          # operands -> Tensor, ONE torch call
    bytes: float
    flops: float
    reps: int
    replaces: str = SEG_TPU


def kernel_cases(X, y, t, folds, k):
    """The main path's kernel calls at its shapes."""
    from repro_torch.core.crossfit import fold_weights
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.core.moments import design
    from repro_torch.kernels.residual_gram import kernel as rg_kernel
    from repro_torch.kernels.residual_gram import ref as rg_ref
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.kernels.seg_gram import ref

    def sym(q):
        # distinct entries of a symmetric (q, q) Gram
        return q * (q + 1) / 2

    n = X.shape[0]
    W = fold_weights(folds, k)                       # (k, n)
    seg = folds.to(torch.int32)
    Dr = design(X, intercept=True, append=y)         # ridge design (n, p+2)
    Dl = design(X, intercept=True)                   # logistic design (n, p+1)
    wg = (0.25 * W).contiguous()                     # first Newton step
    v = (W * (0.5 - t)[None]).contiguous()
    my, mt = X[:, 0].contiguous(), torch.sigmoid(X[:, 0])
    phi = cate_basis(X, 2)
    theta = torch.tensor([1.0, 0.5], device=X.device)
    cols = [c[:, None] for c in (y, t, my, mt)]
    qr, ql, ph = Dr.shape[1], Dl.shape[1], phi.shape[1]

    def batched(builder, arrays, w, dtype):
        return torch.stack([
            ref.seg_gram_plain(builder, [a.to(dtype) for a in arrays],
                               w=w[b][:, None].to(dtype))
            for b in range(k)])

    def gv_plain(dtype):
        return torch.stack([
            ref.seg_gram_plain(ref.build_gram_and_vec,
                               [Dl.to(dtype), wg[b][:, None].to(dtype),
                                v[b][:, None].to(dtype)])
            for b in range(k)])

    def seg_plain(dtype):
        return ref.seg_gram_plain(ref.build_design, [Dr.to(dtype)],
                                  seg=folds, n_segments=k)

    def res_plain(dtype):
        return ref.seg_gram_plain(ref.build_residual,
                                  [c.to(dtype) for c in cols]
                                  + [phi.to(dtype)])

    def meat_plain(dtype):
        return ref.seg_gram_plain(ref.build_residual_meat,
                                  [c.to(dtype) for c in cols]
                                  + [phi.to(dtype),
                                     theta[None].to(dtype)])

    def rg_exact():
        G = res_plain(torch.float64)
        return torch.cat([G[:2, :2].reshape(-1), G[:2, 2]])

    col_bytes = 4 * n * 4 + phi.numel() * 4
    f32 = torch.float32
    return [
        Case("design", "ridge weighted_gram, k=5 folds batched",
             lambda: kern.seg_gram_cuda("design", Dr, w=W),
             lambda: batched(ref.build_design, [Dr], W, f32),
             lambda: batched(ref.build_design, [Dr], W, torch.float64),
             lambda: ((Dr[None] * W[:, :, None]).transpose(1, 2), Dr),
             lambda ab: torch.matmul(*ab),
             Dr.numel() * 4 + W.numel() * 4 + k * qr * qr * 4,
             2.0 * k * n * sym(qr), 3),
        Case("design_segmented", "fold_gram S=5 (parallel_loo)",
             lambda: kern.seg_gram_cuda("design", Dr, seg=seg,
                                        n_segments=k)[0]
             .reshape(k, qr, qr),
             lambda: seg_plain(f32),
             lambda: seg_plain(torch.float64),
             lambda: ((Dr[:, None, :] * (folds[:, None] == torch.arange(
                 k, device=X.device)[None])[:, :, None])
                 .reshape(n, k * qr).T, Dr),
             lambda ab: torch.matmul(*ab),
             Dr.numel() * 4 + n * 4 + k * qr * qr * 4,
             2.0 * n * sym(qr), 3),
        Case("gram_and_vec", "logistic Newton step, k=5 folds batched",
             lambda: kern.seg_gram_cuda("gram_and_vec", Dl,
                                        scalars=(wg, v)),
             lambda: gv_plain(f32), lambda: gv_plain(torch.float64),
             lambda: (torch.cat([Dl[None] * wg[:, :, None], v[:, :, None]],
                                dim=2).transpose(1, 2), Dl),
             lambda ab: torch.matmul(*ab),
             Dl.numel() * 4 + 2 * wg.numel() * 4 + k * (ql + 1) * ql * 4,
             2.0 * k * n * (sym(ql) + ql), 3),
        Case("residual", "final-stage residual_moments (G, b)",
             lambda: kern.seg_gram_cuda("residual", phi,
                                        scalars=(y, t, my, mt))[0],
             lambda: res_plain(f32), lambda: res_plain(torch.float64),
             lambda: (torch.cat([(t - mt)[:, None] * phi,
                                 (y - my)[:, None]], dim=1),),
             lambda a: a[0].T @ a[0],
             col_bytes + 9 * 4, 2.0 * n * sym(ph + 1), 20),
        Case("residual_meat", "final-stage HC0 meat",
             lambda: kern.seg_gram_cuda("residual_meat", phi,
                                        scalars=(y, t, my, mt),
                                        theta=theta)[0],
             lambda: meat_plain(f32), lambda: meat_plain(torch.float64),
             lambda: (ref.build_residual_meat(*cols, phi, theta[None])[0],),
             lambda a: a[0].T @ a[0],
             col_bytes + 2 * 4 + 4 * 4, 2.0 * n * sym(ph) + 8.0 * n, 20),
        Case("residual_gram", "final stage at row_block=0",
             lambda: torch.cat([g.reshape(-1) for g in
                                rg_kernel.residual_gram_cuda(y, t, my, mt,
                                                             phi)]),
             lambda: torch.cat([g.reshape(-1) for g in
                                rg_ref.residual_gram_ref(y, t, my, mt,
                                                         phi)]),
             rg_exact,
             lambda: ((t - mt)[:, None] * phi,),
             lambda a: a[0].T @ a[0],
             col_bytes + 6 * 4, 2.0 * n * (sym(ph) + ph), 20,
             replaces=RG_TPU),
    ]


def phase_kernels(X, y, t, folds, k, timer):
    """Kernel vs plain vs fp64 at the main path's shapes; timings."""
    records = {}
    for c in kernel_cases(X, y, t, folds, k):
        G64 = c.exact()
        Gk = c.kernel()
        Gp = c.plain()
        torch.cuda.synchronize()
        err_k, err_p, kp = rel(Gk, G64), rel(Gp, G64), rel(Gk, Gp)
        max_abs = float((Gk.double() - Gp.double()).abs().max())
        del G64
        ms = timer.ms(c.kernel, c.reps)
        plain_ms = timer.ms(c.plain, c.reps)
        ops = c.lib_prep()
        lib_ms = timer.ms(lambda: c.lib(ops), c.reps)
        del ops
        torch.cuda.empty_cache()
        t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = c.flops / FP32_FLOP_PER_S * 1e3
        ok = kp <= KERNEL_TOL and bool(torch.isfinite(Gk).all())
        log(f"kernel {c.name:17s} [{c.form}] shape={tuple(Gk.shape)} "
            f"err/max|G| kernel={err_k:.3e} plain={err_p:.3e} "
            f"kernel-vs-plain={kp:.3e} (tol {KERNEL_TOL:g}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={max(t_bytes, t_ops):.4f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel {c.name} disagrees with its plain "
                                 f"version: {kp:.3e} > {KERNEL_TOL:g}")
        records[c.name] = {
            "name": f"seg_gram[{c.name}]" if c.name != "residual_gram"
            else "residual_gram",
            "route": "cuda", "source": SEG_SRC, "replaces": c.replaces,
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "err_kernel_vs_fp64": err_k,
            "err_plain_vs_fp64": err_p}
    return records


def phase_invariants(seed: int) -> None:
    """Bitwise: padded tail, w=0 == zeroed rows, empty segment,
    power-of-two weights, run-to-run repeat."""
    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    n, p, k, pad = 70_001, 300, 5, 40_000    # pad adds whole splits
    dev = "cuda"
    D = torch.randn((n, p), generator=g, device=dev)
    seg = torch.randint(0, k, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((k, n), generator=g, device=dev)
    y, t, my, mt = (torch.randn(n, generator=g, device=dev)
                    for _ in range(4))
    phi = torch.randn((n, 2), generator=g, device=dev)

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"invariant broken: {what}")
        log(f"invariant ok: {what}")

    # padded tail: zero data, seg = -1, w = 0 rows appended
    Dp = torch.cat([D, torch.zeros((pad, p), device=dev)])
    segp = torch.cat([seg, torch.full((pad,), -1, dtype=torch.int32,
                                      device=dev)])
    wp = torch.cat([w, torch.zeros((k, pad), device=dev)], dim=1)
    same(kern.seg_gram_cuda("design", D, seg=seg, n_segments=k),
         kern.seg_gram_cuda("design", Dp, seg=segp, n_segments=k),
         "padded tail (design, S=5)")
    same(kern.seg_gram_cuda("design", D, w=w),
         kern.seg_gram_cuda("design", Dp, w=wp.contiguous()),
         "padded tail (design, k=5 batch)")
    # w = 0 masks a row exactly like zeroing its data
    mask = (torch.arange(n, device=dev) % 3 != 0).float()
    same(kern.seg_gram_cuda("residual", phi, scalars=(y, t, my, mt),
                            w=mask),
         kern.seg_gram_cuda("residual", phi * mask[:, None],
                            scalars=(y * mask, t * mask, my * mask,
                                     mt * mask)),
         "w=0 == zeroed rows (residual)")
    same(kern.seg_gram_cuda("design", D, w=mask),
         kern.seg_gram_cuda("design", D * mask[:, None]),
         "w=0 == zeroed rows (design)")
    # an empty segment is exactly zero
    seg_e = torch.where(seg == 2, torch.ones_like(seg), seg)
    G = kern.seg_gram_cuda("design", D, seg=seg_e, n_segments=k)[0]
    q = D.shape[1]
    if not bool((G[2 * q:3 * q] == 0).all()):
        raise AssertionError("invariant broken: empty segment")
    log("invariant ok: empty segment is exactly 0")
    # power-of-two weights scale exactly
    same(2.0 * kern.seg_gram_cuda("design", D, seg=seg, n_segments=k),
         kern.seg_gram_cuda("design", D, seg=seg, n_segments=k,
                            w=torch.full((n,), 2.0, device=dev)),
         "power-of-two weights")
    same(2.0 * kern.seg_gram_cuda("residual_meat", phi,
                                  scalars=(y, t, my, mt),
                                  theta=torch.tensor([1.0, 0.5],
                                                     device=dev)),
         kern.seg_gram_cuda("residual_meat", phi, scalars=(y, t, my, mt),
                            theta=torch.tensor([1.0, 0.5], device=dev),
                            w=torch.full((n,), 2.0, device=dev)),
         "power-of-two weights (residual_meat)")
    # two runs are bitwise equal
    wg, v = w, (w * 0.5).contiguous()
    same(kern.seg_gram_cuda("gram_and_vec", D, scalars=(wg, v)),
         kern.seg_gram_cuda("gram_and_vec", D, scalars=(wg, v)),
         "two runs bitwise equal (gram_and_vec, k=5 batch)")


def phase_small_agreement(seed: int) -> None:
    """The port's fit on the card against its fit on the CPU (plain
    versions), small input, every engine and path."""
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=4000, p=10, seed=seed, device="cpu")
    for engine, rb, st in [("parallel", 512, "pallas"),
                           ("parallel_loo", 512, "pallas"),
                           ("sequential", 512, "pallas"),
                           ("parallel", 0, "chunked")]:
        cfg = CausalConfig(n_folds=5, cate_features=2, engine=engine,
                           inference="jackknife", row_block=rb,
                           row_block_strategy=st)
        out = {}
        for dev in ("cpu", "cuda"):
            r = DML(cfg, device=dev).fit(d.y, d.t, d.X,
                                         gen=torch.Generator().manual_seed(1))
            out[dev] = (r.theta.cpu(), r.cov.cpu(), r.inference().se.cpu())
        e = max(rel(out["cuda"][i], out["cpu"][i]) for i in range(3))
        log(f"small fit cuda vs cpu [{engine}, row_block={rb}, {st}]: "
            f"max rel diff {e:.3e} (tol 1e-4)")
        if not e <= 1e-4:
            raise AssertionError(f"card and CPU fits disagree: {e:.3e}")


def phase_main(data, cfg, expected):
    """One full-width fit + jackknife, launches counted around it."""
    from repro_torch.core import moments
    from repro_torch.core.dml import DML
    from repro_torch.kernels.seg_gram import kernel as kern

    est = DML(cfg)
    torch.cuda.synchronize()
    kern.LAUNCHES.clear()
    moments.FALLBACKS.clear()
    t0 = time.perf_counter()
    res = est.fit(data.y, data.t, data.X,
                  gen=torch.Generator().manual_seed(0))
    inf = res.inference()
    lo, hi = res.ate_interval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kern.LAUNCHES)
    fallbacks = {f: c for f, c in moments.FALLBACKS.items() if c}
    theta, se = res.theta.double().cpu(), inf.se.double().cpu()
    target = torch.tensor([1.0, 0.5], dtype=torch.float64)
    # the k=5 jackknife se has 4 degrees of freedom and can land well
    # below the HC0 sandwich se: hold theta to the larger of the two
    z = (theta - target).abs() / torch.maximum(se, res.stderr.double().cpu())
    tag = (f"{cfg.engine}, row_block={cfg.row_block}, "
           f"{cfg.row_block_strategy}")
    log(f"main path [{tag}]: fit+jackknife {secs:.3f} s, "
        f"theta={theta.tolist()} jackknife se={se.tolist()} "
        f"sandwich se={res.stderr.double().cpu().tolist()} "
        f"|theta-[1,0.5]|/max(se)={z.tolist()} ATE CI=[{lo:.5f}, {hi:.5f}] "
        f"launches={counts} "
        f"fallbacks={fallbacks} diag={res.diagnostics.rows()}")
    if not (torch.isfinite(res.theta).all() and torch.isfinite(res.cov).all()
            and tuple(res.theta.shape) == (2,)
            and tuple(res.cov.shape) == (2, 2)):
        raise AssertionError("non-finite or misshapen theta/cov")
    if not bool((z <= 5.0).all()):
        raise AssertionError(f"theta not within 5 se of [1, 0.5]: {z}")
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    if fallbacks:
        raise AssertionError(f"fallback counters rose: {fallbacks}")
    return counts, secs


def main(argv=None) -> int:
    """Run every phase; 0 only if all passed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="rows; the cell's scale is the default")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--out", default="", help="also write the record here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.config import CausalConfig
        from repro_torch.core.crossfit import fold_ids
        from repro_torch.data.causal_dgp import paper_demo_data
        from repro_torch.kernels.seg_gram import kernel as kern
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    failed = []
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kern.library()
    log(f"built seg_gram.cu in {time.perf_counter() - t0:.1f} s")
    log(kern.build_log().strip())

    k, p, row_block = 5, 500, 65536
    data = paper_demo_data(n=args.n, p=p, seed=args.seed)
    records = {}

    def run(name, fn, *a):
        t = time.perf_counter()
        try:
            out = fn(*a)
            log(f"phase {name}: ok ({time.perf_counter() - t:.1f} s)")
            return out
        except Exception:                     # report, go on, fail at the end
            traceback.print_exc()
            log(f"phase {name}: FAILED")
            failed.append(name)
            return None

    folds = fold_ids(torch.Generator().manual_seed(args.seed), args.n, k,
                     device="cuda")
    records = run("kernels", phase_kernels, data.X, data.y, data.t, folds,
                  k, Timer()) or {}
    torch.cuda.empty_cache()
    run("invariants", phase_invariants, args.seed)
    run("small-agreement", phase_small_agreement, args.seed)

    base = CausalConfig(n_folds=k, nuisance_y="ridge", nuisance_t="logistic",
                        cate_features=2, engine="parallel",
                        inference="jackknife", row_block=row_block,
                        row_block_strategy="pallas")
    iters = base.newton_iters
    paths = [
        ("main:parallel", base,
         {"design": 1, "gram_and_vec": iters, "residual": 1,
          "residual_meat": 1}),
        ("main:parallel_loo", dataclasses.replace(base, engine="parallel_loo"),
         {"design_segmented": 2, "residual": 1, "residual_meat": 1}),
        ("main:row_block=0", dataclasses.replace(base, row_block=0),
         {"residual_gram": 1}),
    ]
    launches = {}
    for name, cfg, expected in paths:
        out = run(name, phase_main, data, cfg, expected)
        torch.cuda.empty_cache()
        if out is not None:
            for key, c in out[0].items():
                launches.setdefault(key, c)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"peak device memory {peak:.2f} GiB")

    for key, rec in records.items():
        rec["launches"] = launches.get(key, 0)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": list(records.values()), "n": args.n, "p": p,
            "k": k, "row_block": row_block}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**line, "card": card, "failed": failed}, indent=1))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
