"""The sweep, the store, jobs and elastic resume under the port's data
mesh, on the CPU: gloo ranks spawned once for the module
(``launch.dist_smoke.spawn_ranks``, four ranks; meshes of 1, 2 and 4 of
them), every result collected and checked here.

  * cells sweeps (a dml column, a drlearner column and a second dml
    column sharing the first one's residual pass): "chunked" panels at
    1, 2 and 4 ranks bitwise the panel with no mesh; "pallas" panels
    (one plain ``seg_reduce`` a block) bitwise across rank counts and
    within rtol 1e-4 plus atol 1e-5 of the panel with no mesh;
  * a column on the shard_map executor, its cells split over 2 and 4
    ranks, bitwise the vmap column with no mesh;
  * a lost shard with no retry budget costs its own column alone, and a
    re-run against the checkpoint restores the neighbour and recomputes
    only that column, bitwise; ``elastic_sweep`` restores on its second
    call, and columns saved on 2 ranks restore on 1;
  * a blocking and a threaded job under a 2-rank mesh, bitwise the
    direct sweep;
  * the store on 1, 2 and 4 ranks, one-shot ≡ incremental on aligned
    ingests, bitwise across rank counts (and the store with no mesh on
    "chunked"; within 1e-5·max + 1e-6 of it on "pallas");
  * against the reference on its folds: the 2-rank panel against
    ``repro.sweep.sweep(..., data_mesh=make_data_mesh())`` at rtol 1e-4
    plus atol 1e-5, and the 2-rank store against
    ``repro.store.MomentStore(data_mesh=)`` at 2e-3
    (tests/test_torch_sweep_cells.py, tests/test_torch_store.py);
  * the refusals left: shard_map with no mesh, a data_mesh that is not a
    DataMesh.

Every rank sets one CPU thread and computes its own no-mesh baselines,
so no bitwise comparison mixes thread counts.  The ranks hand in the
reference's folds by replacing ``engine.cell_folds`` and the store's
``_row_folds``; this module imports JAX only inside functions.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import CausalConfig  # noqa: E402
from repro_torch.launch.dist_smoke import spawn_ranks  # noqa: E402
from repro_torch.store import MomentStore  # noqa: E402
from repro_torch.sweep import SweepSpec, sweep  # noqa: E402

N, P, E, K, RB = 1100, 4, 3, 2, 128
CUT = 4 * RB                      # the store's first ingest: block-aligned
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
KERNEL_TOL = (1e-5, 1e-6)         # x·max + y
STORE_REF_TOL = 2e-3
_SPLITS = {"dml": 3, "drlearner": 4}
_COLS = (("dml", {}), ("drlearner", {}), ("dml", {"cate_features": 2}))


def _cfg(**kw) -> dict:
    base = dict(n_folds=K, inference="none", newton_iters=6, row_block=RB,
                row_block_strategy="chunked")
    base.update(kw)
    return base


def _store_cfg(**kw) -> dict:
    return _cfg(nuisance_t="ridge", discrete_treatment=False, **kw)


def _data(seed: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, P)).astype(np.float32)
    t = (rng.random(N) < 1 / (1 + np.exp(-X[:, 0]))).astype(np.float32)
    y = (1.0 * t + X[:, 0] + rng.standard_normal(N)).astype(np.float32)
    return dict(X=X, y=y, t=t,
                segment_ids=rng.integers(0, E, N).astype(np.int64))


def _spec(strategy: str) -> SweepSpec:
    return SweepSpec(E, tuple((name, CausalConfig(**_cfg(
        row_block_strategy=strategy, **extra))) for name, extra in _COLS))


def _panel(panel) -> list:
    return [None if c.failed else (c.thetas.numpy(), c.ates.numpy(),
                                   c.ses.numpy()) for c in panel.columns]


def _state(store) -> dict:
    return {k: {kk: vv.numpy() for kk, vv in v.items()}
            if isinstance(v, dict) else v.numpy()
            for k, v in store.state_dict().items()}


def _patch_folds(payload: dict) -> None:
    """The reference's folds: each cell's by its port seed, the store's
    by row."""
    from repro_torch.store import store as store_mod
    from repro_torch.sweep import engine

    cells, rows = payload["cell_folds"], payload["row_folds"]
    engine.cell_folds = lambda seed, n, k, device=None: torch.from_numpy(
        cells[int(seed)]).to(device)
    store_mod._row_folds = lambda col_seed, start, n, k: torch.from_numpy(
        rows[start:start + n])


def _stores(kw: dict, strategy: str, mesh) -> dict:
    """Two aligned ingests and one ingest of every row."""
    spec = SweepSpec(E, (("dml", CausalConfig(**_store_cfg(
        row_block_strategy=strategy))),))
    inc = MomentStore(spec, P, data_mesh=mesh, device="cpu")
    for lo, hi in ((0, CUT), (CUT, N)):
        inc.ingest(**{k: v[lo:hi] for k, v in kw.items()})
    once = MomentStore(spec, P, data_mesh=mesh, device="cpu")
    once.ingest(**kw)
    return {"inc": _state(inc), "once": _state(once),
            "panel": _panel(inc.refresh()), "aligned": inc.aligned}


def _rank_main(rank: int, payload: dict) -> dict:
    """Every rank-side case; the parent checks what this returns."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.elastic import elastic_sweep
    from repro_torch.runtime import (JobManager, agree_min,
                                     inject_shard_failure, make_data_mesh)

    torch.set_num_threads(1)
    _patch_folds(payload)
    g1 = dist.new_group([0])
    g2 = dist.new_group([0, 1])
    meshes = {4: make_data_mesh(device="cpu")}
    if rank < 2:
        meshes[2] = make_data_mesh(group=g2, device="cpu")
    if rank == 0:
        meshes[1] = make_data_mesh(group=g1, device="cpu")
    kw = {k: torch.from_numpy(v) for k, v in payload["data"].items()}
    out = {"rank": rank, "agreed": agree_min(meshes[4], 10 + rank),
           "sweep": {}, "store": {}}

    # cells sweeps with no mesh and under each mesh
    for strategy in ("chunked", "pallas"):
        spec = _spec(strategy)
        res = {"single": _panel(sweep(spec, device="cpu", **kw))}
        for s in sorted(meshes):
            res[s] = _panel(sweep(spec, data_mesh=meshes[s], **kw))
        out["sweep"][strategy] = res

    # a shard_map column: its cells split over the ranks
    sm_cfg = CausalConfig(**_cfg(row_block_strategy="pallas",
                                 inference_executor="shard_map"))
    out["shard_map"] = {s: _panel(sweep(SweepSpec(E, (("dml", sm_cfg),)),
                                        data_mesh=meshes[s], **kw))
                        for s in (2, 4) if s in meshes}

    # the store
    for strategy in ("chunked", "pallas"):
        res = {"single": _stores(kw, strategy, None)}
        for s in sorted(meshes):
            res[s] = _stores(kw, strategy, meshes[s])
        out["store"][strategy] = res

    if rank < 2:
        dm = meshes[2]
        # a lost shard with no retry budget; the re-run resumes
        fragile = CausalConfig(**_cfg(runtime_max_retries=0))
        spec = SweepSpec(E, (("dml", fragile),
                             ("drlearner", CausalConfig(**_cfg()))))
        path = payload["ckpt"] + "/resume"
        inject_shard_failure(1)
        try:
            struck = sweep(spec, data_mesh=dm,
                           checkpoint=CheckpointManager(path), **kw)
        finally:
            inject_shard_failure(0)
        again = sweep(spec, data_mesh=dm, checkpoint=CheckpointManager(path),
                      **kw)
        out["resume"] = {
            "plain": _panel(sweep(spec, device="cpu", **kw)),
            "struck": _panel(struck),
            "struck_errors": [c.error for c in struck.columns],
            "again": _panel(again),
            "again_events": [c.events for c in again.columns]}
        es = payload["ckpt"] + "/elastic"
        first = elastic_sweep(spec, directory=es, data_mesh=dm, **kw)
        second = elastic_sweep(spec, directory=es, data_mesh=dm, **kw)
        out["elastic"] = {"first": _panel(first), "second": _panel(second),
                          "events": [c.events for c in second.columns]}

        # jobs: blocking and threaded, the mesh passed as data_mesh=
        jspec = SweepSpec(E, (("dml", CausalConfig(**_cfg())),))
        direct = sweep(jspec, data_mesh=dm, **kw)
        jobs = {}
        for name, block in (("blocking", True), ("threaded", False)):
            job = JobManager().submit(jspec, block=block, data_mesh=dm, **kw)
            events = [e.action for e in job.subscribe()]
            jobs[name] = {"events": events, "status": job.status()["status"],
                          "panel": _panel(job.result(timeout=120))}
        out["jobs"] = {"direct": _panel(direct), **jobs}
    dist.barrier()
    if rank == 0:
        # saved on 2 ranks, restored on 1
        third = elastic_sweep(spec, directory=es, data_mesh=meshes[1], **kw)
        out["elastic"]["one_rank"] = _panel(third)
        out["elastic"]["one_rank_events"] = [c.events
                                             for c in third.columns]
    return out


_REF_KEY_SEED = 5


def _reference_folds() -> dict:
    """The reference's folds: each cell's (dml, drlearner columns) by its
    port seed, and the store's column 0 by row."""
    import jax

    import repro.store.store as jstore_mod
    from repro.core.crossfit import fold_ids as jfold_ids
    from repro.sweep import column_keys as jcolumn_keys
    from repro_torch.sweep import column_keys

    key = jax.random.PRNGKey(_REF_KEY_SEED)
    cells = {}
    for c, (name, _) in enumerate(_COLS[:2]):
        keys = jcolumn_keys(key, c, E)
        for s, seed in enumerate(column_keys(0, c, E).tolist()):
            kf = jax.random.split(keys[s], _SPLITS[name])[0]
            cells[seed] = np.asarray(jfold_ids(kf, N, K)).astype(np.int64)
    rows = np.asarray(jstore_mod._row_folds(jax.random.fold_in(key, 0), 0, N,
                                            K)).astype(np.int64)
    return {"cell_folds": cells, "row_folds": rows}


def _reference(data: dict) -> dict:
    """The reference's cells panel (dml, drlearner) and store under its
    own (1, 1) data mesh."""
    import jax
    import jax.numpy as jnp

    from repro.config import CausalConfig as JCausalConfig
    from repro.runtime import make_data_mesh as jmake_data_mesh
    from repro.store import MomentStore as JMomentStore
    from repro.sweep import SweepSpec as JSweepSpec
    from repro.sweep import sweep as jsweep

    key = jax.random.PRNGKey(_REF_KEY_SEED)
    j = {k: jnp.asarray(v) for k, v in data.items()}
    dm = jmake_data_mesh()
    panel = jsweep(JSweepSpec(E, tuple((name, JCausalConfig(**_cfg()))
                                       for name, _ in _COLS[:2])),
                   X=j["X"], y=j["y"], t=j["t"], segment_ids=j["segment_ids"],
                   key=key, data_mesh=dm)
    store = JMomentStore(JSweepSpec(E, (("dml", JCausalConfig(
        **_store_cfg())),)), n_features=P, key=key, data_mesh=dm)
    for lo, hi in ((0, CUT), (CUT, N)):
        store.ingest(**{k: v[lo:hi] for k, v in j.items()})
    return {"panel": [(np.asarray(c.thetas), np.asarray(c.ates),
                       np.asarray(c.ses)) for c in panel.columns],
            "store": {k: np.asarray(v)
                      for k, v in store.state_dict()["col0"].items()},
            "store_panel": [(np.asarray(c.thetas), np.asarray(c.ates),
                             np.asarray(c.ses))
                            for c in store.refresh().columns]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    data = _data()
    payload = {"data": data, **_reference_folds(),
               "ckpt": str(tmp_path_factory.mktemp("mesh_ckpt"))}
    # the reference's runs (JAX compiles) while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, _rank_main, 4, payload,
                          backend="gloo", device="cpu", timeout=600)
        ref = _reference(data)
        return fut.result(), ref


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[0]


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    return np.array_equal(a, b)


def _close(got, want, **tol) -> None:
    for g, w in zip(got, want):
        assert g is not None and w is not None
        for x, y in zip(g, w):
            np.testing.assert_allclose(x, y, **tol)


def test_ranks_agree_on_a_chunk(ranks):
    assert [r["agreed"] for r in ranks] == [10] * 4


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_sweep_bitwise_across_rank_counts(ranks, strategy):
    """The 3-column cells panel at 1, 2 and 4 ranks, on every rank:
    bitwise one another, and on "chunked" bitwise the panel with no
    mesh; on "pallas" within FIT_TOL of it."""
    res = ranks[0]["sweep"][strategy]
    assert all(c is not None for c in res["single"])
    assert _equal(res[1], res[2]) and _equal(res[2], res[4])
    for r in ranks[1:]:
        assert _equal(r["sweep"][strategy][4], res[4])
        assert _equal(r["sweep"][strategy]["single"], res["single"])
    assert _equal(ranks[1]["sweep"][strategy][2], res[2])
    if strategy == "chunked":
        assert _equal(res[2], res["single"])
    else:
        _close(res[2], res["single"], **FIT_TOL)


def test_sweep_matches_reference_mesh(spawned):
    """The 2-rank panel's dml and drlearner columns against the
    reference's cells sweep under its own data mesh, on its folds."""
    ranks, ref = spawned
    _close(ranks[0]["sweep"]["chunked"][2][:2], ref["panel"], **FIT_TOL)


@pytest.mark.parametrize("s", [2, 4])
def test_shard_map_column_bitwise_vmap(ranks, s):
    """A column on the shard_map executor: each cell whole on one rank,
    the panel gathered on every rank — bitwise the vmap column."""
    vmap = ranks[0]["sweep"]["pallas"]["single"][:1]
    for r in ranks[:s]:
        assert _equal(r["shard_map"][s], vmap)


def test_lost_shard_costs_one_column_and_resumes(ranks):
    """No retry budget on the struck column: it fails on both ranks,
    its neighbour is bitwise; the re-run restores only the neighbour and
    recomputes the struck column, bitwise the run with no mesh."""
    for r in ranks[:2]:
        res = r["resume"]
        assert res["struck"][0] is None
        assert "injected shard failure" in res["struck_errors"][0]
        assert _equal(res["struck"][1], res["plain"][1])
        assert "restored" not in res["again_events"][0]
        assert "restored" in res["again_events"][1]
        assert _equal(res["again"], res["plain"])
    assert _equal(ranks[0]["resume"]["again"], ranks[1]["resume"]["again"])


def test_elastic_sweep_restores_across_rank_counts(ranks):
    """``elastic_sweep``: the second call restores every column bitwise;
    a later call on one rank restores what two ranks saved."""
    el = ranks[0]["elastic"]
    assert all("restored" in ev for ev in el["events"])
    assert _equal(el["second"], el["first"])
    assert _equal(el["first"], ranks[0]["resume"]["plain"])
    assert all("restored" in ev for ev in el["one_rank_events"])
    assert _equal(el["one_rank"], el["first"])


@pytest.mark.parametrize("how", ["blocking", "threaded"])
def test_jobs_under_mesh(ranks, how):
    """``JobManager.submit(data_mesh=)``: the events of one column, and
    the panel bitwise the direct sweep under the same mesh."""
    for r in ranks[:2]:
        job = r["jobs"][how]
        assert job["events"] == ["submitted", "column", "done"]
        assert job["status"] == "done"
        assert _equal(job["panel"], r["jobs"]["direct"])


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_store_under_mesh(ranks, strategy):
    """Two aligned ingests ≡ one ingest of every row under each mesh;
    1, 2 and 4 ranks bitwise; "chunked" bitwise the store with no mesh,
    "pallas" within 1e-5·max + 1e-6 of it."""
    res = ranks[0]["store"][strategy]
    for s in (1, 2, 4):
        assert _equal(res[s]["inc"], res[s]["once"]), s
        assert res[s]["aligned"]
    assert _equal(res[1], res[2]) and _equal(res[2], res[4])
    assert _equal(ranks[3]["store"][strategy][4], res[4])
    if strategy == "chunked":
        assert _equal(res[2], res["single"])
        return
    x, y = KERNEL_TOL
    for key, want in res["single"]["inc"]["col0"].items():
        got = res[2]["inc"]["col0"][key]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=x * np.abs(want).max() + y,
                                   err_msg=key)


def test_store_matches_reference_mesh(spawned):
    """The 2-rank store against ``repro.store.MomentStore(data_mesh=)``
    after the same two ingests, on the reference's row folds."""
    ranks, ref = spawned
    got = ranks[0]["store"]["chunked"][2]
    for key, want in ref["store"].items():
        np.testing.assert_allclose(got["inc"]["col0"][key], want,
                                   rtol=STORE_REF_TOL,
                                   atol=STORE_REF_TOL * np.abs(want).max(),
                                   err_msg=key)
    _close(got["panel"], ref["store_panel"], rtol=STORE_REF_TOL,
           atol=STORE_REF_TOL)


def test_refusals_left():
    """A shard_map column with no mesh fails its own column naming
    DataMesh; a data_mesh that is not a DataMesh raises at entry."""
    kw = {k: torch.from_numpy(v) for k, v in _data().items()}
    cfg = CausalConfig(**_cfg())
    panel = sweep(SweepSpec(E, (("dml", cfg), ("dml", dataclasses.replace(
        cfg, cate_features=2, inference_executor="shard_map")))),
        device="cpu", reuse=False, **kw)
    assert not panel.columns[0].failed
    assert panel.columns[1].failed and "DataMesh" in panel.columns[1].error
    with pytest.raises(TypeError, match="DataMesh"):
        sweep(SweepSpec(E, (("dml", cfg),)), data_mesh=object(),
              device="cpu", **kw)
    with pytest.raises(TypeError, match="DataMesh"):
        MomentStore(SweepSpec(E, (("dml", cfg),)), P, data_mesh=object(),
                    device="cpu")
    from repro_torch.launch.elastic import sweep_checkpoint_manager
    spec = SweepSpec(E, (("dml", cfg),) * 3)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        assert sweep_checkpoint_manager(tmp, spec).keep_latest == 4
