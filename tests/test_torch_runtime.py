"""The port's task runtime (repro_torch.runtime) — every test of
tests/test_runtime.py on the port, plus parity with repro.runtime.

  * futures and the DAG: submit / call / gather chains, structure kept,
    results only after gather, cycles refused, gathers idempotent;
  * chunking bitwise for chunks that do not divide B; zero-length axes
    (evaluated on the meta device, no launch) of map and map_product;
  * the memory model through an injected probe (torch keeps no peak
    counter on the CPU; without a probe the map is one chunk), the
    explicit chunk overriding the budget, max_chunk's floor of 1, the
    probe chunks' outputs kept;
  * the downgrade ladder: bitwise results with every chunk or only the
    first failing, retry events carrying the trigger, an exhausted
    ladder re-raising with no retry event, a CUDA error that poisons the
    context surfacing as itself;
  * map_product against nested loops, chunked, with empty axes;
  * the bootstrap chunked / downgraded / under a budget, bitwise; the
    jackknife through the runtime; as_runtime passing a runtime through;
  * tracing: traced ≡ untraced bitwise, runtime spans, counters and one
    audit row per chunk the model sized;
  * parity with the reference: the same numpy inputs through
    ``repro.runtime.TaskRuntime`` and the port's, exact on a pure
    function under the same chunk and failure pattern, the same
    ``(action, chunk_index, backend)`` events, the same
    ``MemoryModel.max_chunk`` over a grid;
  * jobs: events, status and the panel against a direct sweep.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.inference.executor import VmapExecutor as JVmapExecutor  # noqa: E402
from repro.runtime import MemoryModel as JMemoryModel  # noqa: E402
from repro.runtime import TaskRuntime as JTaskRuntime  # noqa: E402
from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.core.dml import DML  # noqa: E402
from repro_torch.inference.bootstrap import dml_bootstrap  # noqa: E402
from repro_torch.inference.executor import BatchedExecutor  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.runtime import (DOWNGRADE, JobManager, MemoryModel,  # noqa: E402
                                 TaskRuntime, as_runtime, memory)
from repro_torch.runtime import scheduler  # noqa: E402


def _double(x, c):
    # batched: a leading replicate axis
    return {"y": x * 2.0 + c, "s": x.sum(-1)}


_XS_NP = np.arange(14, dtype=np.float32).reshape(7, 2)
_XS = torch.from_numpy(_XS_NP)
_C = torch.tensor(1.0)


# ---------------------------------------------------------------------------
# Futures / task graph
# ---------------------------------------------------------------------------

def test_submit_gather_chain():
    rt = TaskRuntime("vmap")
    a = rt.submit(_double, _XS, _C, label="a")
    b = rt.call(lambda o: o["y"][:3], a, label="slice")
    c = rt.submit(_double, b, torch.tensor(0.0), label="c")
    out = rt.gather(c)
    assert torch.equal(out["y"], (_XS[:3] * 2 + 1) * 2)


def test_gather_many_preserves_structure():
    rt = TaskRuntime("vmap")
    a = rt.submit(_double, _XS, _C)
    b = rt.call(lambda o: float(o["s"].sum()), a)
    ra, rb = rt.gather([a, b])
    assert tuple(ra["y"].shape) == (7, 2)
    assert rb == pytest.approx(float(_XS.sum()))


def test_result_before_gather_raises():
    rt = TaskRuntime("vmap")
    a = rt.submit(_double, _XS, _C)
    with pytest.raises(RuntimeError, match="gather"):
        a.result()


def test_cycle_detection():
    rt = TaskRuntime("vmap")
    a = rt.call(lambda v: v, 1)
    b = rt.call(lambda v: v, a)
    a.deps = (b,)  # forge a cycle
    with pytest.raises(ValueError, match="cycle"):
        rt.gather(b)


def test_gather_is_idempotent():
    rt = TaskRuntime("vmap")
    calls = []
    a = rt.call(lambda: calls.append(1) or 42)
    assert rt.gather(a) == 42
    assert rt.gather(a) == 42
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# Chunked scheduling
# ---------------------------------------------------------------------------

def test_chunk_not_dividing_axis_is_bitwise():
    full = TaskRuntime("vmap").map(_double, _XS, _C)
    for chunk in (1, 2, 3, 5, 7, 100):
        out = TaskRuntime("vmap", chunk=chunk).map(_double, _XS, _C)
        assert torch.equal(full["y"], out["y"])
        assert torch.equal(full["s"], out["s"])


def test_zero_length_replicate_axis():
    out = TaskRuntime("vmap").map(_double, _XS[:0], _C)
    assert tuple(out["y"].shape) == (0, 2)
    assert tuple(out["s"].shape) == (0,)
    assert out["y"].dtype == torch.float32 and out["y"].device.type == "cpu"


def test_zero_length_axis_serial_backend():
    out = TaskRuntime("serial").map(_double, _XS[:0], _C)
    assert tuple(out["y"].shape) == (0, 2)


def test_zero_length_axis_never_reaches_a_kernel():
    """The zero-replicate path evaluates on the meta device: a seg_gram
    call there is refused by the dispatch (no kernel launch, no plain
    run), so a closure that reaches one raises instead of launching."""
    from repro_torch.kernels.seg_gram import ops as sops

    def gram(w, X):
        return sops.fold_weighted_design_gram(X, w)

    with pytest.raises(ValueError, match="meta"):
        TaskRuntime("vmap").map(gram, torch.zeros((0, 5)),
                                torch.ones((5, 3)))


def test_scalar_passthrough_args_survive_budget_and_empty_axis():
    full = TaskRuntime("vmap").map(_double, _XS, 0.5)
    budgeted = TaskRuntime("vmap", memory_budget=1 << 20)
    out = budgeted.map(_double, _XS, 0.5)
    assert torch.equal(full["y"], out["y"])
    # on the CPU without a probe there is no model: one chunk
    assert not [e for e in budgeted.events if e.action == "chunk"]
    empty = TaskRuntime("vmap").map(_double, _XS[:0], 0.5)
    assert tuple(empty["y"].shape) == (0, 2)


def _probe(base, per_rep, seen=None):
    """A deterministic peak: base + per_rep bytes per replicate."""
    def probe(run, chunk):
        if seen is not None:
            seen.append(chunk)
        return run(), float(base + per_rep * chunk)
    return probe


def test_memory_model_and_budget_chunking():
    m = 64

    def outer(v, base):
        return torch.tanh(v[:, :, None] * v[:, None, :] + base).sum((1, 2))

    xs = torch.ones((16, m))
    base = torch.zeros((m, m))
    per_rep = m * m * 4
    seen = []
    probe = _probe(1000, per_rep, seen)
    model = memory.memory_model(outer, xs, (base,), 16, lambda c: probe(
        lambda: None, c)[1])
    assert model == MemoryModel(base=1000.0, slope=float(per_rep))
    budget = int(model.base + 4 * model.slope)
    rt = TaskRuntime("vmap", memory_budget=budget, probe=probe)
    chunk, _ = rt.plan_chunk(outer, xs, (base,), 16)
    assert chunk == 4
    assert seen == [1, 1, 8]       # probed once: chunk 1 twice, then 8
    out = rt.map(outer, xs, base)
    ref = TaskRuntime("vmap").map(outer, xs, base)
    assert torch.equal(out, ref)
    assert any(e.action == "chunk" for e in rt.events)


def test_probe_chunks_are_kept_as_results():
    """An unprobed closure's probe chunks (1, 1, then 8 replicates) are
    the map's first results; the model sizes the rest — bitwise the
    unchunked run, with no replicate computed twice."""
    calls = []

    def fn(x, c):
        calls.append(int(x.shape[0]))
        return _double(x, c)

    xs = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    rt = TaskRuntime("vmap", memory_budget=100 + 3 * 10,
                     probe=_probe(100, 10))
    out = rt.map(fn, xs, _C)
    assert calls == [1, 1, 8, 3, 3, 3, 1]
    assert sum(calls) == 20
    assert torch.equal(out["y"], _double(xs, _C)["y"])


def test_max_chunk_floors_at_one():
    model = MemoryModel(base=0.0, slope=1000.0)
    assert model.max_chunk(1, 8) == 1


def test_explicit_chunk_overrides_budget():
    rt = TaskRuntime("vmap", memory_budget=1, chunk=5)
    chunk, model = rt.plan_chunk(_double, _XS, (_C,), 7)
    assert chunk == 5 and model is None


# ---------------------------------------------------------------------------
# Fault tolerance: retry with backend downgrade
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailingExecutor(BatchedExecutor):
    """Backend that dies on its first ``fail_first`` map calls — the
    stand-in for a lost Ray worker."""

    name: str = "failing"
    fail_first: int = 10 ** 9
    calls: int = 0
    message: str = "synthetic worker loss"

    def map(self, fn, xs, *args):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise RuntimeError(self.message)
        return super().map(fn, xs, *args)


def test_downgrade_result_bitwise_equals_healthy_run():
    healthy = TaskRuntime("vmap", chunk=3).map(_double, _XS, _C)
    rt = TaskRuntime(FailingExecutor(), chunk=3)
    out = rt.map(_double, _XS, _C)
    assert torch.equal(healthy["y"], out["y"])
    downs = [e for e in rt.events if e.action == "downgrade"]
    assert len(downs) == 3
    assert all(e.backend == "vmap" for e in downs)


def test_partial_failure_mid_run_is_bitwise():
    healthy = TaskRuntime("vmap", chunk=3).map(_double, _XS, _C)
    rt = TaskRuntime(FailingExecutor(fail_first=1), chunk=3)
    out = rt.map(_double, _XS, _C)
    assert torch.equal(healthy["y"], out["y"])
    assert sum(e.action == "downgrade" for e in rt.events) == 1


def test_retry_events_carry_triggering_exception():
    before = dict(scheduler.EVENT_COUNTS)
    rt = TaskRuntime(FailingExecutor(), chunk=3)
    rt.map(_double, _XS, _C)
    retries = [e for e in rt.events if e.action == "retry"]
    downs = [e for e in rt.events if e.action == "downgrade"]
    assert len(retries) == 3 and len(retries) == len(downs)
    assert all(e.backend == "failing" for e in retries)
    assert all("synthetic worker loss" in e.detail for e in retries)
    assert [e.chunk_index for e in retries] == [0, 1, 2]
    # the process-wide counts see the same events
    assert scheduler.EVENT_COUNTS["retry"] - before.get("retry", 0) == 3


def test_exhausted_ladder_emits_no_retry_event():
    rt = TaskRuntime(FailingExecutor(), max_retries=0)
    with pytest.raises(RuntimeError, match="synthetic"):
        rt.map(_double, _XS, _C)
    assert not [e for e in rt.events if e.action == "retry"]


def test_exhausted_ladder_reraises():
    rt = TaskRuntime(FailingExecutor(), max_retries=0)
    with pytest.raises(RuntimeError, match="synthetic"):
        rt.map(_double, _XS, _C)


def test_poisoned_context_surfaces_as_itself():
    """A CUDA error after which every launch fails is not walked down the
    ladder into a second, confusing error."""
    msg = "seg_gram[design] launch failed: an illegal memory access was " \
          "encountered (700)"
    rt = TaskRuntime(FailingExecutor(message=msg), chunk=3)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        rt.map(_double, _XS, _C)
    assert [e.action for e in rt.events] == ["chunk"]
    assert scheduler.poisons_context(RuntimeError(msg))
    assert not scheduler.poisons_context(RuntimeError("CUDA out of memory"))


def test_downgrade_table_is_a_ladder():
    assert DOWNGRADE["shard_map"] == "vmap"
    assert DOWNGRADE["vmap"] == "serial"
    assert DOWNGRADE["serial"] is None
    # the shard_map rung needs a data mesh (tests/test_torch_distributed.py)
    with pytest.raises(ValueError, match="DataMesh"):
        TaskRuntime("shard_map")
    with pytest.raises(TypeError, match="DataMesh"):
        TaskRuntime("vmap", data_mesh=object())


# ---------------------------------------------------------------------------
# Nested parallelism
# ---------------------------------------------------------------------------

def test_map_product_matches_nested_loops():
    def cell(xo, xi, c):
        return xo * xi + c

    xo = torch.arange(3, dtype=torch.float32) + 1
    xi = torch.arange(4, dtype=torch.float32)
    out = TaskRuntime("vmap").map_product(cell, xo, xi, _C)
    assert torch.equal(out, xo[:, None] * xi[None, :] + _C)


def test_map_product_chunked_bitwise():
    def cell(xo, xi, c):
        return {"v": xo["a"] * xi + c}

    xo = {"a": torch.arange(5, dtype=torch.float32)}
    xi = torch.arange(6, dtype=torch.float32)
    full = TaskRuntime("vmap").map_product(cell, xo, xi, _C)
    chunked = TaskRuntime("vmap", chunk=7).map_product(cell, xo, xi, _C)
    assert torch.equal(full["v"], chunked["v"])
    assert tuple(chunked["v"].shape) == (5, 6)


def test_map_product_empty_axis():
    def cell(xo, xi):
        return xo * xi

    out = TaskRuntime("vmap").map_product(
        cell, torch.zeros((0,)), torch.arange(4.0))
    assert tuple(out.shape) == (0, 4)


def test_map_product_empty_inner_axis():
    def cell(xo, xi):
        return {"v": xo * xi, "s": xo + xi}

    out = TaskRuntime("vmap").map_product(
        cell, torch.arange(3.0), torch.zeros((0,)))
    assert tuple(out["v"].shape) == (3, 0)
    assert tuple(out["s"].shape) == (3, 0)
    assert out["v"].dtype == torch.float32


def test_map_product_both_axes_empty():
    def cell(xo, xi):
        return xo * xi

    out = TaskRuntime("vmap").map_product(cell, torch.zeros((0,)),
                                          torch.zeros((0,)))
    assert tuple(out.shape) == (0, 0)


# ---------------------------------------------------------------------------
# Integration: bootstrap replicates and the jackknife through the runtime
# ---------------------------------------------------------------------------

_N, _P, _K = 1500, 6, 3


@pytest.fixture(scope="module")
def ctx():
    from repro_torch.data.causal_dgp import make_causal_data
    d = make_causal_data(_N, _P, seed=42, effect=1.5, device="cpu")
    cfg = CausalConfig(n_folds=_K, inference="jackknife", row_block=256,
                       row_block_strategy="pallas")
    return DML(cfg, device="cpu").fit(d.y, d.t, d.X)


def _boot(res, **kw):
    c = res.fit_ctx
    return dml_bootstrap(c.nuis_y, c.nuis_t, n_folds=_K, XW=c.XW, y=c.y,
                         t=c.t, phi=c.phi, seed=11, n_replicates=5,
                         row_block=256, strategy="pallas", **kw)


@pytest.fixture(scope="module")
def whole(ctx):
    return _boot(ctx, executor="vmap")


def test_bootstrap_chunked_bitwise(ctx, whole):
    chunked = _boot(ctx, executor="vmap", chunk=2)
    assert torch.equal(whole.replicates, chunked.replicates)
    assert torch.equal(whole.replicate_se, chunked.replicate_se)


def test_bootstrap_downgrade_bitwise(ctx, whole):
    flaky = _boot(ctx, executor=FailingExecutor(fail_first=1), chunk=2)
    assert torch.equal(whole.replicates, flaky.replicates)
    assert flaky.executor == "failing"


def test_bootstrap_memory_budget_chunks_and_is_exact(ctx, whole):
    """A budget of 2.5 replicates under an injected probe: the probe
    chunks (1, 1, then 3 of the 5) and the model's chunks of 2 give the
    replicates of the unchunked run, bitwise."""
    seen = []
    rt = TaskRuntime("vmap", memory_budget=int(1000 + 2.5 * 100),
                     probe=_probe(1000, 100, seen))
    small = _boot(ctx, executor=rt)
    assert seen == [1, 1, 3]
    assert torch.equal(whole.replicates, small.replicates)
    assert [e.detail for e in rt.events if e.action == "chunk"] == \
        ["b=5 chunk=2"]


def test_jackknife_through_the_runtime(ctx):
    """The k delete-fold solves map through the runtime: serial ≡ vmap
    bitwise, and a downgraded map too."""
    from repro_torch.inference.jackknife import delete_fold_jackknife
    jk = ctx.inference()
    assert jk.executor == "vmap" and tuple(jk.replicates.shape) == (_K, 1)
    assert torch.equal(ctx.inference(executor="serial").replicates,
                       jk.replicates)
    c, cf = ctx.fit_ctx, ctx.crossfit
    flaky = delete_fold_jackknife(c.y, c.t, cf.oof_y, cf.oof_t, cf.folds,
                                  c.phi, _K, row_block=256,
                                  executor=FailingExecutor(fail_first=1))
    assert torch.equal(flaky.replicates, jk.replicates)


def test_as_runtime_passthrough():
    rt = TaskRuntime("serial")
    assert as_runtime(rt) is rt
    assert as_runtime("vmap").name == "vmap"
    assert TaskRuntime("serial").name == "serial"


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def test_traced_map_bitwise_with_spans_counters_and_audit():
    xs = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    plain = TaskRuntime("vmap").map(_double, xs, _C)
    tr = Tracer()
    rt = TaskRuntime("vmap", memory_budget=100 + 3 * 10,
                     probe=_probe(100, 10), tracer=tr)
    out = rt.map(_double, xs, _C, label="boot")
    assert torch.equal(out["y"], plain["y"])
    names = tr.span_names()
    assert names[0] == "runtime.map" and names.count("runtime.chunk") == 7
    assert tr.spans[0].attrs["chunk"] == 3
    snap = tr.metrics.snapshot()
    assert snap["counters"]["runtime.chunks"] == 7
    assert snap["gauges"]["runtime.chunk_size[boot]"] == 3
    rows = tr.audit.as_dicts()
    assert [r["chunk_size"] for r in rows] == [1, 1, 8, 3, 3, 3, 1]
    assert all(r["peak_ratio"] == pytest.approx(1.0) for r in rows[3:])
    # no seg_gram launch on the CPU: the work is not counted, not guessed
    assert all(r["flops"] is None and r["time_ratio"] is None for r in rows)
    g = rt.submit(_double, xs, _C, label="dag")
    rt.gather(g)
    assert "dag.task" in tr.span_names()


# ---------------------------------------------------------------------------
# Parity with the reference runtime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JFailing(JVmapExecutor):
    name: str = "failing"
    fail_first: int = 10 ** 9
    calls: int = 0

    def map(self, fn, xs, *args):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise RuntimeError("synthetic worker loss")
        return super().map(fn, xs, *args)


def _jdouble(x, c):
    return {"y": x * 2.0 + c, "s": x.sum()}


@pytest.mark.parametrize("chunk,fail_first", [(0, 0), (3, 0), (3, 1),
                                              (2, 10 ** 9), (5, 2)])
def test_parity_pure_function_and_events(chunk, fail_first):
    """Exact outputs (x·2 + c and a two-element sum round the same in
    both) and the same (action, chunk_index, backend) events under the
    same chunk and failure pattern."""
    jx = jnp.asarray(_XS_NP)
    jexe = JFailing(fail_first=fail_first) if fail_first else "vmap"
    texe = FailingExecutor(fail_first=fail_first) if fail_first else "vmap"
    jrt = JTaskRuntime(jexe, chunk=chunk)
    trt = TaskRuntime(texe, chunk=chunk)
    want = jrt.map(_jdouble, jx, jnp.float32(1.0))
    got = trt.map(_double, _XS, _C)
    for f in ("y", "s"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    assert [(e.action, e.chunk_index, e.backend) for e in trt.events] == \
        [(e.action, e.chunk_index, e.backend) for e in jrt.events]


def test_parity_max_chunk_grid():
    for base in (0.0, 1e3, 5e6):
        for slope in (0.0, 1.0, 4096.0, 3e6):
            for budget in (0, 1, 10 ** 4, 10 ** 7, 10 ** 9):
                for b in (1, 7, 100):
                    assert MemoryModel(base, slope).max_chunk(budget, b) == \
                        JMemoryModel(base, slope).max_chunk(budget, b)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_data():
    rng = np.random.default_rng(3)
    n, p = 600, 4
    X = rng.standard_normal((n, p)).astype(np.float32)
    t = (rng.random(n) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = (t + X[:, 0] + rng.standard_normal(n)).astype(np.float32)
    return dict(X=X, y=y, t=t, segment_ids=rng.integers(0, 3, n))


def _job_spec():
    from repro_torch.sweep import SweepSpec
    cfg = CausalConfig(n_folds=2, inference="none", row_block=128,
                       newton_iters=4)
    return SweepSpec(3, (("dml", cfg), ("drlearner", cfg)))


def test_job_submit_blocking_matches_sweep(sweep_data):
    from repro_torch.sweep import sweep
    tr = Tracer()
    jm = JobManager(tracer=tr)
    job = jm.submit(_job_spec(), block=True, device="cpu", **sweep_data)
    assert job.done() and job.status()["status"] == "done"
    assert job.status()["columns_done"] == 2
    acts = [e.action for e in job.events]
    assert acts == ["submitted", "column", "column", "done"]
    direct = sweep(_job_spec(), device="cpu", **sweep_data)
    for a, b in zip(job.result().columns, direct.columns):
        assert torch.equal(a.thetas, b.thetas)
        assert torch.equal(a.ates, b.ates)
    assert tr.metrics.snapshot()["counters"]["jobs.done"] == 1
    assert jm.jobs()[job.job_id]["status"] == "done"


def test_job_background_subscribe(sweep_data):
    jm = JobManager()
    job = jm.submit(_job_spec(), device="cpu", **sweep_data)
    seen = [e.action for e in job.subscribe(poll_s=0.01)]
    assert seen[0] == "submitted" and seen[-1] == "done"
    assert seen.count("column") == 2
    assert job.wait(timeout=60) and job.result().columns[0].error is None


def test_job_failure_surfaces(sweep_data):
    jm = JobManager()
    job = jm.submit(_job_spec(), block=True, device="cpu", mode="bogus",
                    **sweep_data)
    assert job.status()["status"] == "failed"
    with pytest.raises(ValueError, match="unknown sweep mode"):
        job.result()
