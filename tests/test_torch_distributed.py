"""The data mesh of the port (``repro_torch.runtime.distributed``) on the
CPU: gloo ranks spawned once for the module (``launch.dist_smoke.
spawn_ranks``, four ranks; groups of 1, 2 and 4 of them), every result
collected and checked here.

  * ordered ``dist_reduce`` — the blocked moments under
    ``use_data_mesh`` at row blocks 256, 128 and 64 of N = 1100 rows (no
    block count divides: padded tails and all-padding blocks) — bitwise
    equal at 1, 2 and 4 ranks and bitwise the single-process chunked
    ``blocked_reduce``; every rank holds the same result;
  * the kernel forms ("pallas": one plain ``seg_reduce`` per block on
    the CPU, the kernel on the card) bitwise across rank counts and
    within 1e-5·max + 1e-6 of the single-process pass;
  * ``init`` seeds the fold: bitwise ``blocked_reduce(init=)``, and two
    aligned ingests bitwise one pass; psum within rtol 2e-5, atol 2e-4
    (the reference's bound for that mode);
  * the ten SPECS fitted under a 2-rank mesh, bitwise their
    single-process chunked fits, and within rtol 1e-4 plus atol 1e-5 of
    the reference's fits under its own (1, 1) mesh on the reference's
    data and folds (ROADMAP §C: fp32 moments summed in another order);
  * the port's ``dist_reduce`` on its (1, 1) mesh against
    ``repro.runtime.dist_reduce`` on the reference's, rtol 1e-5 plus an
    atol of 1e-5·max (fp32 cross-moments, ROADMAP §C);
  * ``ShardMapExecutor`` ≡ ``BatchedExecutor`` bitwise on a bootstrap
    (B = 5: padded at 2 and 4 ranks);
  * one injected lost shard under ``TaskRuntime(data_mesh=)``: exactly
    one downgrade (and its retry), replicates bitwise the healthy run;
  * what crosses the group is accumulators: blocks × the partial's
    bytes; an unknown reduction, a mesh larger or smaller than its group
    and a backend the group does not run all raise;
  * ``make_sharded_causal_data``: the union is deterministic, the shapes
    and the distribution match the reference's.

Ranks set one CPU thread each and compute their own single-process
baselines, so the bitwise comparisons never mix thread counts.  This
module imports JAX only inside functions: the ranks import it too.
"""
import concurrent.futures
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import moments  # noqa: E402
from repro_torch.core.registry import (ROW_BLOCK, SPEC_IDS, SPECS,  # noqa: E402
                                       tree_arrays)
from repro_torch.launch.dist_smoke import spawn_ranks  # noqa: E402
from repro_torch.runtime import (DataMesh, ShardLostError,  # noqa: E402
                                 TaskRuntime, dist_reduce,
                                 inject_shard_failure, make_data_mesh,
                                 use_data_mesh)

N, P, K, B = 1100, 5, 4, 3
RBS = (256, 128, 64)
PSUM_RTOL, PSUM_ATOL = 2e-5, 2e-4
KERNEL_TOL = (1e-5, 1e-6)          # x·max + y
REF_RTOL, REF_ATOL = 1e-4, 1e-5
# how many ways each reference fit splits its key; the first part draws
# its folds (tests/test_torch_conformance_reference.py)
_SPLITS = {"dml": 3, "dml_p2_rb": 3, "dml_loo": 3, "drlearner": 4,
           "orthoiv": 4, "orthoiv_p2_rb": 4, "driv": 4}
_BOOT_B, _BOOT_RB = 5, 256


def _arrays(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        X=rng.standard_normal((N, P)).astype(f32),
        w=rng.exponential(size=N).astype(f32),
        W=rng.exponential(size=(B, N)).astype(f32),
        V=rng.standard_normal((B, N)).astype(f32),
        folds=rng.integers(0, K, N).astype(np.int64),
        ry=rng.standard_normal(N).astype(f32),
        rt=rng.standard_normal(N).astype(f32),
        rz=rng.standard_normal(N).astype(f32),
        Y=rng.standard_normal((B, N)).astype(f32),
        theta=rng.standard_normal((B, P)).astype(f32),
    )


def _forms(a: dict, strategy: str, rb: int) -> dict:
    """Every blocked moment form the estimators reach, on ``a``."""
    kw = dict(row_block=rb, strategy=strategy)
    X, w = a["X"], a["w"]
    zeros = torch.zeros_like(a["Y"])
    return {
        "weighted_gram": moments.weighted_gram(X, w, intercept=True,
                                               append=a["ry"], **kw),
        "gram_and_vec": moments.weighted_gram_and_vec(X, a["W"], a["V"],
                                                      intercept=True, **kw),
        "fold_gram": moments.fold_gram(X, a["folds"], K, intercept=True,
                                       **kw),
        "fold_weighted": moments.fold_weighted_gram(X, a["W"],
                                                    intercept=True, **kw),
        "residual": moments.residual_moments(a["ry"], a["rt"], a["rz"],
                                             w, X, **kw),
        "residual_meat": moments.residual_meat(a["Y"], a["V"], zeros, zeros,
                                               X, a["theta"], w=a["W"],
                                               **kw),
        "iv_gram": moments.iv_gram(a["ry"], a["rt"], a["rz"], X, w, **kw),
        "fold_iv_gram": moments.fold_iv_gram(a["ry"], a["rt"], a["rz"], X,
                                             a["folds"], K, **kw),
        "iv_meat": moments.iv_meat(a["ry"], a["rt"], a["rz"], X,
                                   a["theta"][0], w=w, **kw),
    }


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return [_np(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _block(Xb, wb):
    return (Xb * wb[:, None]).T @ Xb, wb.sum(0)


def _patch_folds(folds):
    from repro_torch.core import drlearner, iv
    crossfit = importlib.import_module("repro_torch.core.crossfit")

    for mod in (crossfit, drlearner, iv):
        mod.fold_ids = lambda gen, n, k, device=None: folds


def _conf_data(spec, raw):
    from repro_torch.data.causal_dgp import CausalData, IVData

    cls = IVData if spec.needs_instrument else CausalData
    return cls(**{f.name: (raw[f.name] if np.ndim(raw[f.name]) == 0 else
                           torch.from_numpy(raw[f.name]))
                  for f in dataclasses.fields(cls)})


def _spec_fits(spec, raw, folds, mesh, single: bool) -> dict:
    data = _conf_data(spec, raw)
    if folds is not None:
        _patch_folds(torch.from_numpy(folds))
    cfg = dataclasses.replace(spec.base_cfg, row_block=ROW_BLOCK,
                              row_block_strategy="chunked")
    out = {}
    if single:
        res = spec.fit(data, cfg, None)
        out["single"] = _np(list(tree_arrays(res)))
    with use_data_mesh(mesh):
        res = spec.fit(data, cfg, None)
    out["mesh"] = _np(list(tree_arrays(res)))
    out["point"] = float(spec.point(res))
    out["theta"] = _np(res.theta) if hasattr(res, "theta") else None
    return out


def _bootstrap(executor, strategy="chunked"):
    from repro_torch.config import CausalConfig
    from repro_torch.core.final_stage import cate_basis
    from repro_torch.core.nuisance import make_nuisance
    from repro_torch.data.causal_dgp import make_causal_data
    from repro_torch.inference.bootstrap import dml_bootstrap

    d = make_causal_data(600, P, seed=3, device="cpu")
    cfg = CausalConfig(n_folds=3, row_block=_BOOT_RB,
                       row_block_strategy=strategy)
    ny = make_nuisance("ridge", "reg", cfg)
    nt = make_nuisance("logistic", "clf", cfg)
    return dml_bootstrap(ny, nt, n_folds=3, XW=d.X, y=d.y, t=d.t,
                         phi=cate_basis(d.X, 2), seed=11,
                         n_replicates=_BOOT_B, executor=executor,
                         row_block=_BOOT_RB, strategy=strategy).replicates


def _refusals(rank: int) -> dict:
    out = {}
    for name, kw in (("too_many", dict(n_hosts=8)),
                     ("too_few", dict(n_hosts=2, n_devices=1)),
                     ("reduction", dict(reduction="median")),
                     ("backend", dict(backend="nccl"))):
        try:
            make_data_mesh(device="cpu", **kw)
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _rank_main(rank: int, payload: dict) -> dict:
    """Every rank-side case; the parent checks what this returns."""
    import torch.distributed as dist
    from repro_torch.inference.executor import (BatchedExecutor,
                                                ShardMapExecutor)
    from repro_torch.runtime import distributed as rd

    torch.set_num_threads(1)
    g1 = dist.new_group([0])
    g2 = dist.new_group([0, 1])
    g2b = dist.new_group([2, 3])
    meshes = {4: make_data_mesh(device="cpu")}
    if rank < 2:
        meshes[2] = make_data_mesh(group=g2, device="cpu")
    if rank == 0:
        meshes[1] = make_data_mesh(group=g1, device="cpu")
    a = {k: torch.from_numpy(v) for k, v in payload["arrays"].items()}
    out = {"rank": rank, "labels": {s: m.label for s, m in meshes.items()},
           "backends": {s: m.backend for s, m in meshes.items()},
           "refusals": _refusals(rank), "forms": {}, "reduce": {}}

    # the blocked moment forms, single-process and under each mesh
    for strategy in ("chunked", "pallas"):
        for rb in RBS:
            res = {"single": _np(_forms(a, strategy, rb))}
            for s in sorted(meshes):
                with use_data_mesh(meshes[s]):
                    res[s] = _np(_forms(a, strategy, rb))
            out["forms"][(strategy, rb)] = res

    # dist_reduce directly: init seeding, two aligned ingests, psum
    X, w = a["X"], a["w"]
    seed = (torch.full((P, P), 0.25), torch.tensor(3.0))
    half = 4 * 128
    for s in sorted(meshes):
        dm = meshes[s]
        r = {"chunked": _np(moments.blocked_reduce(
                 _block, (X, w), row_block=128, strategy="chunked")),
             "ordered": _np(dist_reduce(_block, (X, w), row_block=128,
                                        dm=dm)),
             "seeded_single": _np(moments.blocked_reduce(
                 _block, (X, w), row_block=128, strategy="chunked",
                 init=seed)),
             "seeded": _np(dist_reduce(_block, (X, w), row_block=128, dm=dm,
                                       init=seed)),
             "psum": _np(dist_reduce(_block, (X, w), row_block=128, dm=dm,
                                     reduction="psum"))}
        first = dist_reduce(_block, (X[:half], w[:half]), row_block=128,
                            dm=dm)
        r["two_ingests"] = _np(dist_reduce(_block, (X[half:], w[half:]),
                                           row_block=128, dm=dm, init=first))
        before = rd.TRAFFIC["bytes"]
        with use_data_mesh(dm):
            moments.weighted_gram(X, w, intercept=True, row_block=128,
                                  strategy="chunked")
        r["bytes"] = rd.TRAFFIC["bytes"] - before
        out["reduce"][s] = r

    # the ten SPECS under a 2-rank mesh: ranks 0-1 half of them, 2-3 the
    # other half, each pair's lower rank also fitting single-process
    pair = meshes[2] if rank < 2 else make_data_mesh(group=g2b, device="cpu")
    mine = SPECS[:5] if rank < 2 else SPECS[5:]
    out["specs"] = {
        spec.name: _spec_fits(spec, payload["data"][spec.needs_instrument],
                              payload["folds"].get(spec.name), pair,
                              single=rank % 2 == 0)
        for spec in mine}

    # the shard_map executor against the batched one
    out["vmap"] = _np(_bootstrap(BatchedExecutor()))
    out["shard_map"] = {s: _np(_bootstrap(ShardMapExecutor(meshes[s])))
                        for s in (2, 4) if s in meshes}

    # one lost shard under the runtime's data-mesh rung; the second
    # strategy's downgraded chunk runs the same blocks on one rank
    out["ladder"] = {}
    for strategy in ("chunked", "pallas") if rank < 2 else ():
        healthy_rt = TaskRuntime("vmap", data_mesh=meshes[2], chunk=2)
        healthy = _bootstrap(healthy_rt, strategy)
        inject_shard_failure(1)
        struck_rt = TaskRuntime("vmap", data_mesh=meshes[2], chunk=2)
        try:
            struck = _bootstrap(struck_rt, strategy)
        finally:
            inject_shard_failure(0)
        out["ladder"][strategy] = {
            "healthy": _np(healthy), "struck": _np(struck),
            "plain": _np(_bootstrap("vmap", strategy)),
            "healthy_events": [e.action for e in healthy_rt.events],
            "events": [(e.action, e.chunk_index, e.backend, e.detail)
                       for e in struck_rt.events]}
    return out


@pytest.fixture(scope="module")
def spawned():
    import jax

    from repro.core import registry as jregistry
    from repro.core.crossfit import fold_ids as jfold_ids

    data, folds = {}, {}
    for spec in SPECS:
        ref = jregistry.get_spec(spec.name)
        if spec.needs_instrument not in data:
            jd = ref.make_data(jax.random.PRNGKey(42))
            data[spec.needs_instrument] = {
                k: (float(v) if np.ndim(v) == 0 else np.array(v, np.float32))
                for k, v in vars(jd).items()}
        if spec.name in _SPLITS:
            kf = jax.random.split(jax.random.PRNGKey(0),
                                  _SPLITS[spec.name])[0]
            folds[spec.name] = np.asarray(
                jfold_ids(kf, N, spec.base_cfg.n_folds)).astype(np.int64)
    payload = {"arrays": _arrays(), "data": data, "folds": folds}
    # the reference's fits (JAX compiles) while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, _rank_main, 4, payload,
                          backend="gloo", device="cpu", timeout=600)
        refs = {spec.name: _reference_mesh_fit(spec.name) for spec in SPECS}
        return fut.result(), refs


def _reference_mesh_fit(name):
    """(point, theta or None) of the reference's fit of spec ``name`` at
    the test's config under its own (1, 1) data mesh."""
    import jax

    from repro.core import registry as jregistry
    from repro.runtime import make_data_mesh as jmake_data_mesh
    from repro.runtime import use_data_mesh as juse_data_mesh

    ref = jregistry.get_spec(name)
    cfg = dataclasses.replace(ref.base_cfg, row_block=ROW_BLOCK,
                              row_block_strategy="chunked")
    with juse_data_mesh(jmake_data_mesh()):
        jres = ref.fit(ref.make_data(jax.random.PRNGKey(42)), cfg,
                       jax.random.PRNGKey(0))
    theta = np.asarray(jres.theta) if hasattr(jres, "theta") else None
    return ref.point(jres), theta


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[0]


def _equal(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def _leaves(tree):
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_meshes_formed_and_refusals(ranks):
    assert ranks[0]["labels"] == {1: "1x1:ordered", 2: "2x1:ordered",
                                  4: "4x1:ordered"}
    assert all(b == "gloo" for b in ranks[0]["backends"].values())
    ref = ranks[0]["refusals"]
    assert ref["too_many"][0] == "RuntimeError" and "8 ranks" in \
        ref["too_many"][1]
    assert ref["too_few"][0] == "ValueError" and "new_group" in \
        ref["too_few"][1]
    assert ref["reduction"][0] == "ValueError"
    assert ref["backend"][0] == "ValueError" and "gloo" in ref["backend"][1]
    # without a process group: the (1, 1) mesh; asking for more raises
    dm = make_data_mesh(device="cpu")
    assert (dm.group, dm.n_shards, dm.backend, dm.label) == (
        None, 1, None, "1x1:ordered")
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        make_data_mesh(backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="DataMesh"):
        dist_reduce(_block, [torch.ones(8, 2), torch.ones(8)], row_block=4)


@pytest.mark.parametrize("rb", RBS)
def test_moments_ordered_bitwise_across_rank_counts(ranks, rb):
    """Every blocked form, chunked: 1, 2 and 4 ranks ≡ single-process,
    byte for byte, on every rank of the mesh."""
    res = ranks[0]["forms"][("chunked", rb)]
    for s in (1, 2, 4):
        assert _equal(res[s], res["single"]), (rb, s)
    for r in ranks[1:]:
        other = r["forms"][("chunked", rb)]
        assert _equal(other[4], res[4])
        if 2 in other:
            assert _equal(other[2], res[2])


@pytest.mark.parametrize("rb", RBS)
def test_kernel_forms_under_mesh(ranks, rb):
    """The "pallas" forms, one seg_reduce a block: bitwise across rank
    counts, within 1e-5·max + 1e-6 of the single-process pass."""
    res = ranks[0]["forms"][("pallas", rb)]
    assert _equal(res[1], res[2]) and _equal(res[1], res[4])
    assert _equal(ranks[3]["forms"][("pallas", rb)][4], res[4])
    x, y = KERNEL_TOL
    for form in res["single"]:
        for got, want in zip(_leaves(res[2][form]),
                             _leaves(res["single"][form])):
            assert got.shape == want.shape, form
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=x * np.abs(want).max() + y,
                                       err_msg=f"{form} rb={rb}")


@pytest.mark.parametrize("s", [1, 2, 4])
def test_dist_reduce_ordered_seeded_and_psum(ranks, s):
    r = ranks[0]["reduce"][s]
    assert _equal(r["ordered"], r["chunked"])
    assert _equal(r["seeded"], r["seeded_single"])
    assert _equal(r["two_ingests"], r["chunked"])
    for got, want in zip(r["psum"], r["chunked"]):
        np.testing.assert_allclose(got, want, rtol=PSUM_RTOL,
                                   atol=PSUM_ATOL)
    assert _equal(ranks[s - 1]["reduce"][s]["ordered"], r["ordered"])


def test_bytes_across_the_group_are_accumulators(ranks):
    """weighted_gram at row_block 128: the blocks (9, rounded up to a
    multiple of the ranks) times (G (6, 6) + n_eff) in fp32 — never the
    rows (1100 × 5 floats)."""
    for s in (1, 2, 4):
        blocks = -(-(-(-N // 128)) // s) * s
        assert ranks[0]["reduce"][s]["bytes"] == blocks * (36 + 1) * 4
        assert ranks[0]["reduce"][s]["bytes"] < N * P * 4


def _spec_result(ranks, name):
    lower = next(r for r in ranks[::2] if name in r["specs"])
    upper = ranks[lower["rank"] + 1]
    return lower["specs"][name], upper["specs"][name]


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_registry_fit_two_rank_mesh_bitwise(ranks, spec):
    """The full fit under a 2-rank mesh is the single-process chunked
    fit bit for bit, and both ranks hold it."""
    lo, hi = _spec_result(ranks, spec.name)
    assert len(lo["mesh"]) == len(lo["single"]) > 0
    assert _equal(lo["mesh"], lo["single"]), spec.name
    assert _equal(hi["mesh"], lo["mesh"]), spec.name


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_registry_fit_matches_reference_mesh(spawned, spec):
    """Against the reference's fit of the same config under its own
    (1, 1) data mesh, on its data and folds."""
    point, theta = spawned[1][spec.name]
    lo, _ = _spec_result(spawned[0], spec.name)
    np.testing.assert_allclose(lo["point"], point, rtol=REF_RTOL,
                               atol=REF_ATOL, err_msg=spec.name)
    assert (lo["theta"] is None) == (theta is None), spec.name
    if theta is not None:
        np.testing.assert_allclose(lo["theta"], theta, rtol=REF_RTOL,
                                   atol=REF_ATOL, err_msg=spec.name)


@pytest.mark.parametrize("s", [2, 4])
def test_shard_map_equals_vmap_bitwise(ranks, s):
    for r in ranks[:s]:
        assert np.array_equal(r["shard_map"][s], r["vmap"])
        assert np.array_equal(r["vmap"], ranks[0]["vmap"])


@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_lost_shard_downgrades_once_bitwise(ranks, strategy):
    """B = 5 in chunks of 2: the first chunk's shard is lost and that
    chunk reruns on each rank alone — one retry, one downgrade, and the
    replicates of the healthy run bit for bit (chunked: also the run with
    no mesh at all; the kernel forms' blocks differ from one whole pass,
    by tolerance)."""
    for r in ranks[:2]:
        lad = r["ladder"][strategy]
        assert lad["healthy_events"] == ["chunk"]
        acts = [(e[0], e[1]) for e in lad["events"]]
        assert acts == [("chunk", -1), ("retry", 0), ("downgrade", 0)]
        assert lad["events"][1][2] == "data_mesh[2x1:ordered]:vmap"
        assert lad["events"][2][2] == "vmap"
        assert "injected shard failure" in lad["events"][2][3]
        assert np.array_equal(lad["struck"], lad["healthy"])
        assert np.array_equal(lad["healthy"], ranks[0]["ladder"][strategy][
            "healthy"])
        if strategy == "chunked":
            assert np.array_equal(lad["healthy"], lad["plain"])
        else:
            np.testing.assert_allclose(lad["healthy"], lad["plain"],
                                       rtol=1e-4, atol=1e-5)


def test_local_mesh_matches_reference_dist_reduce():
    """The port's (1, 1) mesh against ``repro.runtime.dist_reduce`` on
    the reference's own ``make_data_mesh()``; and bitwise the port's
    chunked fold."""
    import jax.numpy as jnp

    from repro.runtime import dist_reduce as jdist_reduce
    from repro.runtime import make_data_mesh as jmake_data_mesh

    a = _arrays(11)
    X, w = torch.from_numpy(a["X"]), torch.from_numpy(a["w"])
    dm = make_data_mesh(device="cpu")
    for rb in RBS:
        got = dist_reduce(_block, (X, w), row_block=rb, dm=dm)
        assert _equal(_np(got), _np(moments.blocked_reduce(
            _block, (X, w), row_block=rb, strategy="chunked")))
        want = jdist_reduce(
            lambda xb, wb: ((xb * wb[:, None]).T @ xb, wb.sum(0)),
            (jnp.asarray(a["X"]), jnp.asarray(a["w"])), row_block=rb,
            dm=jmake_data_mesh())
        for g, wv in zip(got, want):
            wv = np.asarray(wv)
            np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5,
                                       atol=1e-5 * np.abs(wv).max())


def test_local_mesh_runtime_and_executor():
    """On the (1, 1) mesh, in this process: the shard_map executor from
    the active mesh ≡ vmap, and a lost shard costs one downgrade."""
    from repro_torch.inference.executor import (ShardMapExecutor,
                                                make_executor)

    dm = make_data_mesh(device="cpu")
    assert isinstance(dm, DataMesh)
    with pytest.raises(ValueError, match="DataMesh"):
        make_executor("shard_map")
    with use_data_mesh(dm):
        exe = make_executor("shard_map")
    assert isinstance(exe, ShardMapExecutor) and exe.mesh is dm
    vmap = _bootstrap("vmap")
    assert torch.equal(_bootstrap(exe), vmap)
    rt = TaskRuntime("vmap", data_mesh=dm)
    inject_shard_failure(1)
    try:
        got = _bootstrap(rt)
    finally:
        inject_shard_failure(0)
    assert torch.equal(got, vmap)
    assert [e.action for e in rt.events] == ["retry", "downgrade"]
    inject_shard_failure(1)
    try:
        with pytest.raises(ShardLostError):
            with use_data_mesh(dm):
                moments.weighted_gram(torch.ones(10, 2), torch.ones(10),
                                      row_block=4)
    finally:
        inject_shard_failure(0)
    with pytest.raises(TypeError, match="DataMesh"):
        TaskRuntime("vmap", data_mesh=object())


def test_sharded_causal_data():
    """Each shard from (seed, shard) alone: the union is deterministic,
    shards differ, and shapes and moments match the reference's
    ``make_sharded_causal_data`` in distribution."""
    import jax

    from repro.data.causal_dgp import make_sharded_causal_data as jmake
    from repro_torch.data.causal_dgp import make_sharded_causal_data

    n, p, S = 40_000, 6, 4
    shards = [make_sharded_causal_data(n, p, S, s, seed=5, device="cpu")
              for s in range(S)]
    again = make_sharded_causal_data(n, p, S, 2, seed=5, device="cpu")
    assert torch.equal(again.X, shards[2].X) and torch.equal(again.y,
                                                             shards[2].y)
    assert not torch.equal(shards[0].X, shards[1].X)
    X = torch.cat([d.X for d in shards])
    t = torch.cat([d.t for d in shards])
    assert X.shape == (n, p) and t.shape == (n,)
    ref = [jmake(jax.random.PRNGKey(5), n, p, S, s) for s in range(S)]
    assert ref[0].X.shape == shards[0].X.shape
    assert shards[0].true_ate == ref[0].true_ate == 1.0
    jX = np.concatenate([np.asarray(d.X) for d in ref])
    jt = np.concatenate([np.asarray(d.t) for d in ref])
    se = 1 / np.sqrt(n)
    assert abs(float(X.mean()) - jX.mean()) < 5 * se / np.sqrt(p)
    assert abs(float(X.std()) - jX.std()) < 5 * se
    assert set(np.unique(t.numpy())) == set(np.unique(jt)) == {0.0, 1.0}
    assert abs(float(t.mean()) - jt.mean()) < 0.05
    with pytest.raises(ValueError, match="shards"):
        make_sharded_causal_data(10, p, 3, 0, device="cpu")
