"""The per-device cost counter (``repro_torch.launch.op_cost``), the
roofline (``launch.roofline``) and the kernels' cost formulas.

  * flops and bytes are exact for mm / bmm / einsum; a Python loop of 10
    matmuls counts 10 times (the analogue of ``tests/test_hlo_cost.py``'s
    trip counts); ``torch.utils.checkpoint``'s recompute counts the
    forward's products twice;
  * views are free, an index gather is charged twice its output;
  * on a fake group of 4 (one subprocess for the module) the five
    collectives' wire bytes are the ring factors' exactly, and under
    DTensor on a fake (4, 4) mesh the counts are one rank's: the local
    product, not the global one DTensor's sharding propagation runs;
  * the peak holds an ordinary op's output storage in full, a
    collective's output at its own bytes (a fake group's shard-dim
    all-to-all returns a view of 16 copies), and ``peak_top`` lists the
    largest storages live at the peak by op, shape and dtype;
  * ``charge`` adds exactly and counts launches;
  * a smoke train step under the counter is bitwise the uncounted one;
  * ``model_flops_for`` equals the reference's for every arch x shape,
    ``Roofline.row()`` the reference's given its TPU constants;
  * the kernels' ``cost`` functions give the formulas the kernel table's
    bounds were computed with.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import op_cost, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F = 4  # fp32 bytes


def test_matmul_counts_exact():
    a, b = torch.randn(64, 256), torch.randn(256, 128)
    with op_cost.count() as c:
        a @ b
    assert c.flops == 2 * 64 * 256 * 128
    assert c.bytes == F * (64 * 256 + 256 * 128 + 64 * 128)
    x, y = torch.randn(3, 16, 32), torch.randn(3, 32, 8)
    with op_cost.count() as c:
        torch.bmm(x, y)
    assert c.flops == 2 * 3 * 16 * 32 * 8
    with op_cost.count() as c:
        torch.einsum("bij,bjk->bik", x, y)
    assert c.by_op["bmm"][0] == 2 * 3 * 16 * 32 * 8
    assert c.flops == 2 * 3 * 16 * 32 * 8


def test_loop_counts_every_trip():
    a, b = torch.randn(32, 64), torch.randn(64, 64)
    with op_cost.count() as one:
        a @ b
    with op_cost.count() as ten:
        for _ in range(10):
            a @ b
    assert ten.flops == 10 * one.flops and ten.bytes == 10 * one.bytes
    assert ten.by_op["mm"][2] == 10


def test_checkpoint_recompute_counts_forward_twice():
    from torch.utils.checkpoint import checkpoint
    M, K, N = 32, 48, 16
    x = torch.randn(M, K, requires_grad=True)
    w = torch.randn(K, N, requires_grad=True)

    def f(x, w):
        return torch.tanh(x @ w)

    with op_cost.count() as plain:
        f(x, w).sum().backward()
    with op_cost.count() as remat:
        checkpoint(f, x, w, use_reentrant=False).sum().backward()
    assert plain.by_op["mm"][0] == 3 * 2 * M * K * N
    assert remat.by_op["mm"][0] == 4 * 2 * M * K * N


def test_views_free_and_gathers_at_output():
    x = torch.randn(64, 32)
    with op_cost.count() as c:
        x.view(32, 64)
        x.t()
        x[:, :4]
        x.reshape(2048)
    assert c.flops == 0 and c.bytes == 0
    idx = torch.tensor([3, 1, 7])
    with op_cost.count() as c:
        out = x[idx]
    assert c.bytes == 2 * out.numel() * F


def test_pointwise_and_reductions_one_flop_an_output():
    x = torch.randn(16, 8)
    with op_cost.count() as c:
        torch.exp(x)
    assert c.flops == 16 * 8 and c.bytes == 2 * 16 * 8 * F
    with op_cost.count() as c:
        x.sum(-1)
    assert c.flops == 16


def test_charge_adds_exactly():
    with op_cost.count() as c:
        op_cost.charge("flash_attention", 1.5e9, 2.5e6)
        op_cost.charge("flash_attention", 0.5e9, 0.5e6)
        op_cost.charge("gla", 1e6, 1e3)
    assert c.flops == 2.0e9 + 1e6 and c.bytes == 3.0e6 + 1e3
    assert c.launches == {"flash_attention": 2, "gla": 1}
    op_cost.charge("gla", 1.0, 1.0)             # outside: nothing counted
    assert c.launches["gla"] == 1 and not op_cost.counting()


def test_peak_bytes_tracks_live_outputs():
    with op_cost.count() as c:
        a = torch.empty(1000)
        b = torch.zeros(1000)
        del a
        d = torch.ones(500)
    assert c.peak_bytes == 2000 * F
    del b, d


def test_peak_counts_a_strided_output_storage_in_full():
    # an ordinary op's output holds its whole storage: 7 elements for
    # 4 at stride 2
    with op_cost.count() as c:
        x = torch.empty_strided((4,), (2,))
    assert x.untyped_storage().nbytes() == 7 * F
    assert c.peak_bytes == 7 * F
    assert c.peak_top == [{"op": "empty_strided", "shape": [4],
                           "dtype": "float32", "bytes": 7 * F}]


def test_peak_top_lists_the_largest_live_storages():
    with op_cost.count() as c:
        small = torch.empty(10)
        gone = torch.empty(1, 5000)
        del gone
        a = torch.empty(100, dtype=torch.float64)
        b = torch.empty(2, 300)
        d = torch.empty(50, dtype=torch.bfloat16)
        e = torch.empty(3)
        f = torch.empty(7, dtype=torch.int64)
        g = torch.empty(1)
    # the list is the peak's, with what was freed after it
    assert c.peak_bytes == 5010 * F
    assert c.peak_top == [
        {"op": "empty", "shape": [1, 5000], "dtype": "float32",
         "bytes": 5000 * F},
        {"op": "empty", "shape": [10], "dtype": "float32", "bytes": 10 * F}]
    del small, a, b, d, e, f, g
    with op_cost.count() as c:
        a = torch.empty(100, dtype=torch.float64)
        b = torch.empty(2, 300)
        d = torch.empty(50, dtype=torch.bfloat16)
        e = torch.empty(3)
        f = torch.empty(7, dtype=torch.int64)
        h = torch.empty(1)
        i = torch.zeros(4, 4)
    assert c.peak_bytes == 800 + 2400 + 100 + 12 + 56 + 4 + 64
    assert c.peak_top == [
        {"op": "empty", "shape": [2, 300], "dtype": "float32",
         "bytes": 2400},
        {"op": "empty", "shape": [100], "dtype": "float64", "bytes": 800},
        {"op": "empty", "shape": [50], "dtype": "bfloat16", "bytes": 100},
        {"op": "zeros", "shape": [4, 4], "dtype": "float32", "bytes": 64},
        {"op": "empty", "shape": [7], "dtype": "int64", "bytes": 56}]
    assert len(c.peak_top) == op_cost.PEAK_TOP
    del a, b, d, e, f, h, i


def test_train_step_under_counter_is_bitwise():
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import Model
    cfg = get_config("granite-3-2b-smoke")
    pc = ParallelConfig(attention_impl="chunked", attention_chunk=8,
                        microbatch=2)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    outs = []
    for counted in (False, True):
        model = Model(cfg, pc, device="cpu", seed=0)
        state = init_state(model)
        step = make_train_step(model, TrainConfig(warmup_steps=1))
        ctx = op_cost.count() if counted else None
        if ctx:
            with ctx as tot:
                params, opt, met = step(state.params, state.opt, batch)
            assert tot.flops > 0 and tot.peak_bytes > 0
        else:
            params, opt, met = step(state.params, state.opt, batch)
        outs.append((params, opt, met))
    (p0, o0, m0), (p1, o1, m1) = outs
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(o0[m][k], o1[m][k]) for m in ("m", "v")
               for k in o0[m])
    assert torch.equal(m0["loss"], m1["loss"])


def test_model_flops_and_row_match_reference():
    for arch in list(ARCH_IDS) + [a + "-smoke" for a in ARCH_IDS]:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        for js, ts in zip(jconfig.SHAPES, tconfig.SHAPES):
            assert roofline.model_flops_for(tcfg, ts) == \
                jroofline.model_flops_for(jcfg, js)
    kw = dict(flops=3.1e14, hbm_bytes=2.2e12, wire_bytes=4.4e10,
              model_flops=5.0e16, chips=256)
    for scale in (1e-3, 1.0, 30.0):
        j = jroofline.Roofline(**{**kw, "wire_bytes": kw["wire_bytes"]
                                  * scale})
        t = roofline.Roofline(**{**kw, "wire_bytes": kw["wire_bytes"] * scale},
                              peak_flops=jroofline.PEAK_FLOPS,
                              hbm_bw=jroofline.HBM_BW,
                              link_bw=jroofline.LINK_BW)
        assert t.row() == j.row()
    h100 = roofline.Roofline(**kw)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == \
        (989e12, 3.35e12, 450e9)


def test_wire_bytes_ring_factors():
    S, G = 1000.0, 8
    assert roofline.wire_bytes("all-reduce", S, G) == 2 * S * 7 / 8
    assert roofline.wire_bytes("all-gather", S, G) == S * 7 / 8
    assert roofline.wire_bytes("reduce-scatter", S, G) == S * 7
    assert roofline.wire_bytes("all-to-all", S, G) == S * 7 / 8
    assert roofline.wire_bytes("collective-permute", S, G) == S
    with pytest.raises(ValueError):
        roofline.wire_bytes("broadcast", S, G)


@pytest.mark.parametrize("B,H,T,D,C", [(8, 40, 1024, 64, 16),
                                       (4, 8, 200, 64, 8),
                                       (2, 64, 1024, 64, 32)])
def test_scan_costs_are_the_kernel_tables(B, H, T, D, C):
    """gla_cost / ssd_cost (and their backwards) against the formulas
    the kernel table's bounds were written with (r/k/v in bf16 or fp32,
    w, u and the SSD inputs in fp32)."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    m = dict(device="meta")
    for el, dt in ((2, torch.bfloat16), (4, torch.float32)):
        q, k, v = (torch.empty(B, H, T, D, dtype=dt, **m) for _ in range(3))
        w = torch.empty(B, H, T, D, **m)
        u = torch.empty(H, D, **m)
        n = B * H * T
        for uu in (u, None):
            flops, nbytes = sk.gla_cost(q, k, v, w, uu, C)
            assert nbytes == (3 * el * n * D + 4 * n * D + el * n * D
                              + 4 * B * H * D * D
                              + (4 * H * D if uu is not None else 0))
            assert flops == B * H * (T // C) * (
                2 * (C * (C + 1) // 2) * D * 2 + 2 * C * D * D * 2)
        io = 3 * el * n * D + 4 * n * D + 4 * H * D
        assert sk.gla_bwd_cost(q, k, v, w, u, C) == \
            (2 * sk.gla_cost(q, k, v, w, u, C)[0], 2 * io + el * n * D)
    N = D
    q, k = (torch.empty(B, T, N, **m) for _ in range(2))
    v = torch.empty(B, H, T, N, **m)
    a = torch.empty(B, H, T, **m)
    n = B * H * T
    tri = C * (C + 1) // 2
    flops, nbytes = sk.ssd_cost(q, k, v, a, C)
    assert nbytes == (2 * 4 * B * T * N + 4 * n * N + 4 * n + 4 * n * N
                      + 4 * B * H * N * N)
    assert flops == (B * (T // C) * 2 * tri * N
                     + B * H * (T // C) * (2 * tri * N + 2 * 2 * C * N * N))
    io = 2 * 4 * B * T * N + 4 * n * N + 4 * B * H * T
    assert sk.ssd_bwd_cost(q, k, v, a, C) == (2 * flops, 2 * io + 4 * n * N)


@pytest.mark.parametrize("B,S,H,KV,D,Dv,causal", [
    (8, 1024, 32, 8, 64, 64, True), (2, 1024, 128, 128, 192, 128, True),
    (8, 1500, 6, 6, 64, 64, False)])
def test_flash_costs_are_the_kernel_tables(B, S, H, KV, D, Dv, causal):
    from repro_torch.kernels.flash_attention import kernel as fk
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(B, S, H, D, **m)
    k = torch.empty(B, S, KV, D, **m)
    v = torch.empty(B, S, KV, Dv, **m)
    el, o, lse = 2, B * S * H * Dv, B * H * S
    pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
    assert fk.cost(q, k, v, causal=causal, lse=True) == (
        2.0 * pairs * (D + Dv),
        el * (q.numel() + k.numel() + v.numel() + o) + 4 * lse)
    assert fk.bwd_cost(q, k, v, causal=causal) == (
        2.0 * pairs * (3 * D + 2 * Dv),
        el * (2 * (q.numel() + k.numel() + v.numel()) + 2 * o) + 4 * lse)


def test_seg_gram_cost_is_the_runtime_audits():
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.runtime.memory import LaunchCount
    c = LaunchCount()
    c.add("design", 5, 1000, 1, 7, 7, 123.0)
    c.add("pair", 1, 1000, 4, 3, 9, 50.0)
    assert kern.cost(5, 1000, 1, 7, 7, 123.0) == \
        (2.0 * 5 * 1000 * 28, 123.0 + 4.0 * 5 * 7 * 7)
    assert (c.launches, c.flops, c.hbm_bytes) == (
        2, 2.0 * 5 * 1000 * 28 + 2.0 * 1000 * 27,
        123.0 + 4.0 * 5 * 49 + 50.0 + 4.0 * 4 * 27)


_FAKE_SCRIPT = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.sharding import P, NamedSharding, distribute
    from repro_torch.launch import op_cost
    out = {}
    dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
    g = dist.group.WORLD
    name = g.group_name
    x = torch.randn(64, 32)                    # 8192 bytes
    ops = torch.ops._c10d_functional
    with op_cost.count() as c:
        ops.wait_tensor(ops.all_reduce(x, "sum", name))
        ops.wait_tensor(ops.all_gather_into_tensor(x, 4, name))
        ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", 4, name))
        ops.wait_tensor(ops.all_to_all_single(x, [16] * 4, [16] * 4, name))
        ops.wait_tensor(ops.isend(x, 1, 0, name))
    out["coll"] = c.coll_by_op
    out["count"] = c.coll_count
    dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    with FakeTensorMode():
        # DTensor's shard-dim all-to-all: on a fake group a view of 16
        # copies of its input; the peak counts the view's own bytes
        x = torch.empty(64, 32)
        with op_cost.count() as c:
            y = torch.ops._dtensor.shard_dim_alltoall(
                x, 1, 0, dist.group.WORLD.group_name)
        out["a2a"] = [list(y.shape), y.untyped_storage().nbytes(),
                      c.peak_bytes, c.peak_top]
    dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        a = distribute(torch.empty(64, 256), NamedSharding(mesh, P("data", None)))
        b = distribute(torch.empty(256, 512), NamedSharding(mesh, P(None, "model")))
        with op_cost.count() as c:
            y = a @ b
        out["dt_flops"] = c.flops
        out["dt_bytes"] = c.bytes
        out["dt_mm"] = c.by_op["mm"][2]
        out["dt_local"] = list(y.to_local().shape)
    print(json.dumps(out))
""")


def test_collectives_and_dtensor_on_fake_groups():
    res = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    S, G = 64 * 32 * F, 4
    assert out["coll"] == {
        "all-reduce": 2 * S * (G - 1) / G,
        "all-gather": G * S * (G - 1) / G,         # payload: the output
        "reduce-scatter": S / G * (G - 1),         # payload: the output
        "all-to-all": S * (G - 1) / G,
        "collective-permute": S}
    assert out["count"] == 5
    assert out["a2a"] == [[4, 512], 16 * S, S, [
        {"op": "shard_dim_alltoall", "shape": [4, 512], "dtype": "float32",
         "bytes": S}]]
    assert out["dt_flops"] == 2 * 16 * 256 * 128   # rank 0's (16, 256)@(256, 128)
    assert out["dt_bytes"] == F * (16 * 256 + 256 * 128 + 16 * 128)
    assert out["dt_mm"] == 1 and out["dt_local"] == [16, 128]
