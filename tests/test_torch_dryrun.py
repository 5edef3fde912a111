"""The multi-pod dry run (``repro_torch.launch.dryrun``) on ``-smoke``
architectures at the production meshes, in one subprocess (the fake
default group of 512 ranks is the process's): a train cell
(yi-34b's heads do not divide the "model" axis: sequence-sharded q), a
prefill, deepseek-v3's expert-parallel decode on the multi-pod mesh,
zamba2's long_500k (the cache's seq over the data axis) and the skip of
a quadratic arch's long_500k.  Every record parses with the reference's
keys; a failing cell is reported with status "error" and makes the exit
code 1 while the sweep goes on; ``--paper-cell`` names the slice that
brings it.
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
    try:
        dryrun.main(["--paper-cell"])
        paper = "ran"
    except NotImplementedError as e:
        paper = str(e)
    print(json.dumps({"rcs": rcs, "paper": paper}))
""")


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    res = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"}, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    return out, {(r["arch"], r["shape"]): r for r in recs}, res.stderr


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
    assert "A.14b" in out["paper"]
