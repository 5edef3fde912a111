"""The elastic re-mesh and the paper's steps on a device mesh, on gloo
ranks (``launch.dist_smoke.spawn_ranks``: two ranks, then one, spawned
once for the module), every result checked here.

  * ``CheckpointManager.restore(shardings=)`` against the reference's
    ``tests/test_checkpoint.py::test_elastic_restore_new_sharding``: the
    same arrays through numpy saved, restored under a (1, 1) mesh's
    shardings, every leaf placed so and equal;
  * the re-mesh proper: granite-3-2b-smoke (fp32) under
    ``default_rules(fsdp=True)`` trains 2 steps on a 2-rank host mesh,
    saves (rank 0 writes the gathered state), goes on 2 steps (the
    uninterrupted run), and is restored by ``elastic_restore`` on 2
    ranks and on 1 and continued 2 steps: every restored leaf placed as
    ``state_shardings`` says, the 2-rank continuation bitwise the
    uninterrupted run, and every run within LOSS_RTOL of the same 4
    steps with no mesh (fp32 sums in another order across the shards);
  * ``batch_sharding`` / ``ShardedFeed(sharding=)``: each rank holds its
    half of the batch;
  * ``sharding.pad`` on a batch-sharded DTensor is ``F.pad`` of the
    whole, and ``sharding.cumsum`` ``torch.cumsum``, its gradient too;
  * ``make_dml_step`` / ``make_iv_step`` / ``make_sweep_step`` on inputs
    placed by ``row_sharding`` on 2 ranks (each rank's moments on its
    rows, summed by all-reduces) within STEP_TOL·max of the step with no
    mesh, and every rank's results equal; the DML and IV steps also
    under "pallas" at a row_block between a rank's rows and all of them
    (SHORT_SHARD_BLOCK), where each rank makes as many seg_gram passes
    on its shard as the step with no mesh makes on all the rows;
  * the train CLI under a one-rank host mesh (``launch.train.main`` in a
    group of one);
  * on a one-rank host mesh, 2 train steps bitwise the same steps with
    no mesh, every parameter too (each op on the one rank's whole
    shards is the plain op).
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import (CausalConfig, ParallelConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.lm_data import lm_batch, step_generator  # noqa: E402
from repro_torch.launch.dist_smoke import spawn_ranks  # noqa: E402
from repro_torch.launch.train import init_state, make_train_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH, B, S, SEED = "granite-3-2b-smoke", 4, 32, 3
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
N, P, K, E = 2048, 6, 5, 4          # the steps' rows, covariates, folds
STEP_TOL = 1e-5                     # |sharded - none| <= STEP_TOL·max
SHORT_SHARD_BLOCK = 1536            # N / 2 < row_block < N: a shard is
                                    # one block, the whole is two


def _model(rules=None):
    return Model(get_config(ARCH), ParallelConfig(), rules, device="cpu",
                 seed=0)


def _batch(s):
    return lm_batch(step_generator(SEED, s), B, S, get_config(ARCH).vocab_size)


def _cfg():
    return CausalConfig(n_folds=K, nuisance_y="ridge", nuisance_t="logistic",
                        nuisance_z="logistic", cate_features=2,
                        newton_iters=4, inference="none")


def _step_data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, P)).astype(np.float32)
    z = (rng.random(N) < 0.5).astype(np.float32)
    t = ((X[:, 0] + z + rng.standard_normal(N)) > 0.5).astype(np.float32)
    y = (1.5 * t + X[:, 1] + rng.standard_normal(N)).astype(np.float32)
    folds = rng.permutation(np.arange(N) % K).astype(np.int64)
    sids = rng.integers(0, E, N).astype(np.int64)
    return {k: torch.from_numpy(v) for k, v in
            dict(X=X, y=y, t=t, z=z, folds=folds, sids=sids).items()}


def _steps():
    from repro_torch.launch import dml_cell, sweep_cell
    cfg = _cfg()
    short = dataclasses.replace(cfg, row_block=SHORT_SHARD_BLOCK,
                                row_block_strategy="pallas")
    dml = (("X", "y", "t", "folds"), dml_cell.row_sharding)
    iv = (("X", "y", "t", "z", "folds"),
          lambda m: dml_cell.row_sharding(m, with_instrument=True))
    return {"dml": (dml_cell.make_dml_step(cfg, device="cpu"), *dml),
            "iv": (dml_cell.make_iv_step(cfg, device="cpu"), *iv),
            "sweep": (sweep_cell.make_sweep_step(
                dataclasses.replace(cfg, cate_features=1), E, device="cpu"),
                ("X", "y", "t", "sids"), sweep_cell.row_sharding),
            "dml:pallas": (dml_cell.make_dml_step(short, device="cpu"),
                           *dml),
            "iv:pallas": (dml_cell.make_iv_step(short, device="cpu"), *iv)}


def _seg_passes(fn, *args):
    """(``fn(*args)``, the number of ``seg_gram.ops.seg_reduce`` calls it
    made): the passes that launch the kernel on a card."""
    from repro_torch.kernels.seg_gram import ops
    orig, calls = ops.seg_reduce, [0]

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    ops.seg_reduce = counted
    try:
        return fn(*args), calls[0]
    finally:
        ops.seg_reduce = orig


def _train(state, step, feed, n, losses):
    for _ in range(n):
        state.params, state.opt, met = step(state.params, state.opt,
                                            next(feed))
        losses.append(float(met["loss"]))


def _placements(state, shardings):
    """Whether every leaf of ``state`` is a DTensor placed as its
    sharding says."""
    from repro_torch.models.params import flatten
    got, want = flatten(state), flatten(shardings)
    return set(got) == set(want) and all(
        tuple(got[k].placements) == tuple(want[k].placements)
        for k in want)


def _remesh_rank(rank: int, ckpt: str, data: dict, restore_only: bool):
    """One rank's part (module docstring); ``restore_only``: the one-rank
    run that resumes the two-rank save."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.data.pipeline import ShardedFeed, batch_sharding
    from repro_torch.distributed.sharding import (cumsum, default_rules,
                                                  distribute, dtensor_ops,
                                                  mesh_context, pad)
    from repro_torch.launch import train
    from repro_torch.launch.elastic import elastic_restore, state_shardings
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    out = {}
    rules = default_rules(fsdp=True)
    model = _model(rules)
    mesh = make_host_mesh()
    shardings = state_shardings(model, rules, mesh)
    step = make_train_step(model, TCFG)
    mgr = CheckpointManager(ckpt)
    with mesh_context(mesh), dtensor_ops():
        if not restore_only:
            state = train.place_state(init_state(model), shardings)
            feed = ShardedFeed(_batch, sharding=batch_sharding(mesh))
            first = next(feed)
            out["local_tokens"] = first["tokens"].to_local().clone()
            feed.close()
            feed = ShardedFeed(_batch, sharding=batch_sharding(mesh))
            out["losses"] = []
            _train(state, step, feed, 2, out["losses"])
            mgr.save(2, {"params": state.params, "opt": state.opt})
            _train(state, step, feed, 2, out["losses"])
            feed.close()
        restored, meta = elastic_restore(mgr, model, rules, mesh, step=2)
        out["step"] = meta["step"]
        out["placed"] = _placements(restored, shardings)
        st = train.TrainState(restored["params"], restored["opt"], 2)
        feed = ShardedFeed(_batch, sharding=batch_sharding(mesh),
                           start_step=2)
        out["resumed"] = []
        _train(st, step, feed, 2, out["resumed"])
        feed.close()
        x = distribute(torch.arange(2 * 5 * 3, dtype=torch.float32)
                       .reshape(2, 5, 3), batch_sharding(mesh))
        out["pad"] = torch.equal(pad(x, (0, 0, 2, 0)).full_tensor(),
                                 F.pad(x.full_tensor(), (0, 0, 2, 0)))
        out["pad_placements"] = pad(x, (0, 0, 2, 0)).placements == (
            Shard(0), Replicate())
        # the scans' cumsum on a DTensor, forward and backward
        w = torch.linspace(-1, 1, 30).reshape(2, 5, 3)
        xg = distribute(torch.sin(torch.arange(30.0)).reshape(2, 5, 3),
                        batch_sharding(mesh)).requires_grad_(True)
        (cumsum(xg, 1) * w).sum().backward()
        xp = xg.detach().full_tensor().requires_grad_(True)
        (torch.cumsum(xp, 1) * w).sum().backward()
        out["cumsum"] = (torch.equal(cumsum(xg, 1).full_tensor(),
                                     torch.cumsum(xp, 1))
                         and torch.equal(xg.grad.full_tensor(), xp.grad))
        if restore_only:
            return out
        steps = {}
        for name, (fn, names, row_sharding) in _steps().items():
            sh = row_sharding(mesh)
            res, steps[name + ":seg"] = _seg_passes(
                fn, *[distribute(data[k], sh[k]) for k in names])
            steps[name] = [r if not isinstance(r, DTensor) else
                           r.full_tensor() for r in res]
            steps[name + ":plain"] = all(not isinstance(r, DTensor)
                                         for r in res)
        out["steps"] = steps
    return out


def _one_rank(rank: int, ckpt: str, data: dict):
    from repro_torch.data.pipeline import ShardedFeed, batch_sharding
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  default_rules, dtensor_ops,
                                                  mesh_context)
    from repro_torch.launch import train
    from repro_torch.launch.elastic import state_shardings
    from repro_torch.launch.mesh import make_host_mesh

    out = _remesh_rank(rank, ckpt, data, restore_only=True)
    # one rank: the mesh's step is the plain step, bit for bit
    rules, mesh = default_rules(fsdp=False), make_host_mesh()
    plain, placed = _model(rules), _model(rules)
    st0, st1 = init_state(plain), train.place_state(
        init_state(placed), state_shardings(placed, rules, mesh))
    out["plain_losses"], out["mesh_losses"] = [], []
    _train(st0, make_train_step(plain, TCFG), iter([_batch(s) for s in
                                                    range(2)]), 2,
           out["plain_losses"])
    with mesh_context(mesh), dtensor_ops():
        feed = ShardedFeed(_batch, sharding=batch_sharding(mesh))
        _train(st1, make_train_step(placed, TCFG), feed, 2,
               out["mesh_losses"])
        feed.close()
    out["params_bitwise"] = all(torch.equal(v, st1.params[k].full_tensor())
                                for k, v in st0.params.items())
    # the reference's restore onto a new mesh's shardings
    mesh = make_host_mesh()
    mgr = CheckpointManager(ckpt + "_arrays")
    st = {k: torch.from_numpy(v) for k, v in data["arrays"].items()}
    mgr.save(1, {"params": {"w": st["w"], "b": st["b"]}, "step": st["step"]})
    sh = NamedSharding(mesh, P("data", None))
    restored, _ = mgr.restore(
        {"params": {"w": st["w"], "b": st["b"]}, "step": st["step"]},
        shardings={"params": {"w": sh, "b": NamedSharding(mesh, P(None))},
                   "step": NamedSharding(mesh, P())})
    w = restored["params"]["w"]
    out["arrays"] = {"w": w.full_tensor(), "b": restored["params"]["b"]
                     .full_tensor(), "step": restored["step"].full_tensor()}
    out["w_placements"] = tuple(w.placements) == tuple(sh.placements)
    out["cli"] = train.main(["--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16", "--ckpt-dir",
                             ckpt + "_cli", "--ckpt-every", "2"])
    out["cli_saved"] = CheckpointManager(ckpt + "_cli").latest_step()
    return out


def _reference_arrays():
    """The reference test's state (``tests/test_checkpoint.py::_state``)
    through numpy."""
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(0)
    st = {"w": jax.random.normal(key, (4, 8)), "b": jnp.zeros((8,)),
          "step": jnp.asarray(3, jnp.int32)}
    return {k: np.asarray(v) for k, v in st.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("remesh") / "ckpt")
    data = _step_data()
    data["arrays"] = _reference_arrays()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the same 4 steps with no mesh, beside the ranks
        def plain():
            model = _model()
            state, step, losses = init_state(model), make_train_step(
                model, TCFG), []
            feed = iter([_batch(s) for s in range(4)])
            _train(state, step, feed, 4, losses)
            steps = {}
            for name, (fn, names, _) in _steps().items():
                res, steps[name + ":seg"] = _seg_passes(
                    fn, *[data[k] for k in names])
                steps[name] = list(res)
            return losses, steps

        none = pool.submit(plain)
        two = spawn_ranks(_remesh_rank, 2, ckpt, data, False)
        one = spawn_ranks(_one_rank, 1, ckpt, data)
        return {"none": none.result(), "two": two, "one": one[0],
                "arrays": data["arrays"]}


def test_restore_shardings_like_reference(runs):
    one = runs["one"]
    assert one["w_placements"]
    for k, v in runs["arrays"].items():
        np.testing.assert_array_equal(one["arrays"][k].numpy(), v)


def test_remesh_losses_and_placements(runs):
    want, _ = runs["none"]
    two, one = runs["two"], runs["one"]
    for r in two:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
        assert r["losses"] == two[0]["losses"]       # every rank alike
        assert r["step"] == 2 and r["placed"]
        assert r["resumed"] == r["losses"][2:]       # 2 ranks -> 2 ranks
    assert one["step"] == 2 and one["placed"]        # 2 ranks -> 1 rank
    np.testing.assert_allclose(one["resumed"], want[2:], rtol=LOSS_RTOL)


def test_batch_sharding_splits_the_batch(runs):
    whole = _batch(0)["tokens"]
    halves = [r["local_tokens"] for r in runs["two"]]
    assert [h.shape[0] for h in halves] == [B // 2, B // 2]
    assert torch.equal(torch.cat(halves), whole)


def test_pad_and_cumsum_on_a_dtensor(runs):
    for r in runs["two"] + [runs["one"]]:
        assert r["pad"] and r["pad_placements"] and r["cumsum"]


@pytest.mark.parametrize("name", ["dml", "iv", "sweep", "dml:pallas",
                                  "iv:pallas"])
def test_steps_under_row_sharding(runs, name):
    _, none = runs["none"]
    got = [r["steps"] for r in runs["two"]]
    for g in got:
        assert g[name + ":plain"]             # whole moments, plain tensors
        for a, b in zip(g[name], got[0][name]):
            assert torch.equal(a, b)          # every rank alike
    for a, b in zip(got[0][name], none[name]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= STEP_TOL * scale, name


@pytest.mark.parametrize("name", ["dml:pallas", "iv:pallas"])
def test_short_shards_take_the_kernel_route(runs, name):
    """A shard of no more rows than row_block takes the route of the
    global rows: the fused pass on each rank, one for each of the step
    with no mesh."""
    _, none = runs["none"]
    assert none[name + ":seg"] > 0
    for r in runs["two"]:
        assert r["steps"][name + ":seg"] == none[name + ":seg"]


def test_one_rank_mesh_step_is_the_plain_step(runs):
    one = runs["one"]
    assert one["mesh_losses"] == one["plain_losses"]
    assert one["params_bitwise"]


def test_train_cli_under_a_host_mesh(runs):
    assert runs["one"]["cli"] == 0
    assert runs["one"]["cli_saved"] == 2
