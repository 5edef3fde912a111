"""The multi-pod dry run (``repro_torch.launch.dryrun``) on ``-smoke``
architectures at the production meshes, in one subprocess (the fake
default group of 512 ranks is the process's): a train cell
(yi-34b's heads do not divide the "model" axis: sequence-sharded q), a
prefill, deepseek-v3's expert-parallel decode on the multi-pod mesh,
zamba2's long_500k (the cache's seq over the data axis) and the skip of
a quadratic arch's long_500k.  Every record parses with the reference's
keys; a failing cell is reported with status "error" and makes the exit
code 1 while the sweep goes on.  ``--paper-cell`` at 65,536 x 50 on
both meshes and the three lowerings (``launch/dml_cell``,
``launch/sweep_cell``) run in the same process: rows sharded over every
rank, each rank's moments summed by all-reduces.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("status", "flops_per_chip", "hbm_bytes_per_chip",
        "wire_bytes_per_chip", "collective_by_op", "collective_count",
        "model_flops", "t_compute", "t_memory", "t_collective", "bottleneck",
        "step_time", "useful_frac", "mfu_bound", "memory", "lower_s")

_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    path = sys.argv[1]
    runs = [["--arch", "yi-34b-smoke", "--shape", "train_4k"],
            ["--arch", "granite-3-2b-smoke", "--shape", "prefill_32k"],
            ["--arch", "deepseek-v3-671b-smoke", "--shape", "decode_32k",
             "--mesh", "multi"],
            ["--arch", "zamba2-1.2b-smoke", "--shape", "long_500k"],
            ["--arch", "granite-3-2b-smoke", "--shape", "long_500k"],
            ["--arch", "no-such-arch", "--shape", "decode_32k"]]
    rcs = [dryrun.main(r + ["--json", path]) for r in runs]
    paper = dryrun.main(["--paper-cell", "--n", str(PN), "--p", str(PP),
                         "--mesh", "both", "--json", sys.argv[2]])

    # the lowerings on the single pod, and each step's count on one device
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.config import CausalConfig
    from repro_torch.launch import dml_cell, op_cost, sweep_cell
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    cfg = CausalConfig(n_folds=5, cate_features=1)
    lowered = {}
    for name, lower, step, names, specs in (
            ("dml", lambda: dml_cell.lower_dml_cell(mesh, n=PN, p=PP),
             dml_cell.make_dml_step(cfg, device="cpu"),
             ("X", "y", "t", "folds"), dml_cell.input_specs(PN, PP)),
            ("iv", lambda: dml_cell.lower_iv_cell(mesh, n=PN, p=PP),
             dml_cell.make_iv_step(cfg, device="cpu"),
             ("X", "y", "t", "z", "folds"),
             dml_cell.input_specs(PN, PP, with_instrument=True)),
            ("sweep", lambda: sweep_cell.lower_sweep_cell(
                mesh, n=SN, p=SP, n_segments=SE),
             sweep_cell.make_sweep_step(cfg, SE, device="cpu"),
             ("X", "y", "t", "sids"), sweep_cell.input_specs(SN, SP))):
        tot, args = lower()
        with FakeTensorMode():
            ins = [torch.zeros(specs[k][0], dtype=specs[k][1])
                   for k in names]
            with op_cost.count() as one:
                step(*ins)
        lowered[name] = {"flops": tot.flops, "args": args,
                         "coll": tot.coll_by_op, "one_flops": one.flops,
                         "one_args": sum(x.numel() * x.element_size()
                                         for x in ins)}
    jax = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
    print(json.dumps({"rcs": rcs, "paper": paper, "lowered": lowered,
                      "jax": jax}))
""")
# the paper cell's and the lowerings' sizes (the sweep's E segments)
PN, PP = 65536, 50
SN, SP, SE = 16384, 20, 8


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    paper = path.parent / "paper.jsonl"
    script = (f"PN, PP, SN, SP, SE = {PN}, {PP}, {SN}, {SP}, {SE}\n"
              + _SCRIPT)
    res = subprocess.run([sys.executable, "-c", script, str(path),
                          str(paper)],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"}, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    recs += [json.loads(x) for x in paper.read_text().splitlines()]
    return out, {(r["arch"], r["shape"], r["mesh"]) if r["arch"].startswith(
        "dml-") else (r["arch"], r["shape"]): r for r in recs}, res.stderr


def test_cells_trace_ok(sweep):
    out, recs, _ = sweep
    assert out["rcs"][:5] == [0, 0, 0, 0, 0]
    for cell in (("yi-34b-smoke", "train_4k"),
                 ("granite-3-2b-smoke", "prefill_32k"),
                 ("deepseek-v3-671b-smoke", "decode_32k"),
                 ("zamba2-1.2b-smoke", "long_500k")):
        rec = recs[cell]
        assert rec["status"] == "ok", rec
        assert all(k in rec for k in KEYS), set(KEYS) - set(rec)
        assert rec["flops_per_chip"] > 0 and rec["hbm_bytes_per_chip"] > 0
        mem = rec["memory"]
        assert 0 < mem["param_bytes"] <= mem["argument_bytes"] \
            <= mem["peak_bytes"]
        assert rec["step_time"] == max(rec["t_compute"], rec["t_memory"],
                                       rec["t_collective"])
        assert rec["wire_bytes_per_chip"] == pytest.approx(
            sum(rec["collective_by_op"].values()))
    assert recs[("deepseek-v3-671b-smoke", "decode_32k")]["mesh"] == \
        "2x16x16"
    assert recs[("deepseek-v3-671b-smoke", "decode_32k")]["chips"] == 512
    assert recs[("yi-34b-smoke", "train_4k")]["mesh"] == "16x16"


def test_quadratic_long_context_is_skipped(sweep):
    _, recs, _ = sweep
    rec = recs[("granite-3-2b-smoke", "long_500k")]
    assert rec["status"] == "skipped"
    assert "sub-quadratic" in rec["reason"]


def test_a_failing_cell_exits_1(sweep):
    out, recs, stderr = sweep
    assert out["rcs"][5] == 1
    rec = recs[("no-such-arch", "decode_32k")]
    assert rec["status"] == "error" and "no-such-arch" in rec["error"]
    assert "[FAIL] no-such-arch/decode_32k" in stderr
    assert out["paper"] == 0                 # --paper-cell ran, all ok
    assert out["jax"] == []                  # no JAX, no reference


@pytest.mark.parametrize("engine", ["parallel", "parallel_loo"])
@pytest.mark.parametrize("mesh,chips", [("16x16", 256), ("2x16x16", 512)])
def test_paper_cell_records(sweep, engine, mesh, chips):
    """``--paper-cell``: the reference's record keys, status ok, X's
    argument bytes this rank's row shard, the moments' all-reduces."""
    _, recs, _ = sweep
    rec = recs[(f"dml-crossfit-{engine}", f"{PN}rows", mesh)]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips
    assert all(k in rec for k in KEYS), set(KEYS) - set(rec)
    rows = PN // chips
    # X (rows, p) fp32; y, t fp32 and the fold ids int64 a row
    assert rec["memory"]["argument_bytes"] == rows * (PP * 4 + 4 + 4 + 8)
    assert rec["collective_by_op"].get("all-reduce", 0) > 0
    assert set(rec["collective_by_op"]) == {"all-reduce"}   # no row moves
    assert rec["model_flops"] == 2.0 * 5 * PN * PP * PP * 17 / 4
    assert rec["step_time"] == max(rec["t_compute"], rec["t_memory"],
                                   rec["t_collective"])


@pytest.mark.parametrize("name", ["dml", "iv", "sweep"])
def test_lowered_cells_hold_their_rows_share(sweep, name):
    """``lower_dml_cell`` / ``lower_iv_cell`` / ``lower_sweep_cell`` on
    the single pod: this rank's arguments are 1/256 of the step's, its
    flops within 2x of 1/256 of the one-device count (the step's small
    solves run whole on every rank: the sweep's E·K Gauss-Jordan MM
    steps are the most of its count at this size, so its bound is
    looser), an all-reduce and no other collective."""
    out, _, _ = sweep
    low = out["lowered"][name]
    assert low["args"] * 256 == low["one_args"]
    share = low["flops"] / (low["one_flops"] / 256)
    assert 0.5 <= share <= (2.0 if name != "sweep" else 8.0), share
    assert set(low["coll"]) == {"all-reduce"}
