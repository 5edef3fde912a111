"""The sharding layer (``repro_torch.distributed.sharding``) and the
production cells (``repro_torch.launch.cells``) held against the
reference's (``repro.distributed.sharding``, ``repro.launch.cells``),
compared exactly, for every registry arch and its ``-smoke`` variant x
the four shape cells x the single- and multi-pod meshes:

  * each cell's rules, every parameter's PartitionSpec path by path, the
    batch and decode-cache specs path by path, every ``ParamDef.axes``
    leaf by leaf, ``Model.input_specs`` (shapes and dtypes against the
    reference's ``ShapeDtypeStruct``s), ``supports_shape`` and
    ``ShapeConfig`` / ``SHAPES``;
  * the ports of ``tests/test_sharding.py``'s five tests;
  * ``constrain`` returns its argument itself outside a mesh;
  * on a fake default group of 16 ranks (one subprocess for the module),
    the spec-to-placements map on a (2, 2, 4) mesh, a tuple entry
    included, and ``distribute``'s local shards.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models.params import map_schema  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ARCH_IDS) + [a + "-smoke" for a in ARCH_IDS]
AXIS_SIZE = {"data": 16, "model": 16, "pod": 2}


def _jflat(tree):
    """{dotted path: leaf} of a reference pytree of specs / structs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP) or hasattr(x, "axes"))[0]
    return {".".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in leaves}


def _tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_tflat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shape_config():
    assert [tuple(vars(s).values()) for s in tconfig.SHAPES] == \
        [tuple(vars(s).values()) for s in jconfig.SHAPES]
    assert set(tconfig.SHAPE_BY_NAME) == set(jconfig.SHAPE_BY_NAME)


def test_arch_ids_match_reference():
    from repro_torch.configs import ARCH_IDS as TARCH_IDS
    assert TARCH_IDS == tuple(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch):
    """Rules, param specs, ParamDef axes, batch / cache specs,
    input_specs and supports_shape of every (shape, mesh) cell."""
    for shape in jconfig.SHAPES:
        for mp in (False, True):
            jc = jcells.make_cell(arch, shape.name, multi_pod=mp)
            tc = cells.make_cell(arch, shape.name, multi_pod=mp)
            where = f"{arch}/{shape.name}/{'multi' if mp else 'single'}"
            assert tc.rules.rules == jc.rules.rules, where
            assert tc.name == jc.name
            jm, tm = jc.model(), tc.model()
            assert tm.supports_shape(tc.shape) == jm.supports_shape(jc.shape)
            jspec = _jflat(jm.param_specs(jc.rules))
            tspec = _tflat(tm.param_specs(tc.rules))
            assert {k: tuple(v) for k, v in jspec.items()} == tspec, where
            jaxes = {k: (d.shape, d.axes) for k, d in
                     _jflat(jm.schema()).items()}
            taxes = {}
            map_schema(lambda p, d: taxes.__setitem__(p, (d.shape, d.axes)),
                       tm.schema())
            assert taxes == jaxes, where
            assert {k: tuple(v) for k, v in jcells.batch_pspecs(jc).items()} \
                == cells.batch_pspecs(tc), where
            jin, tin = jm.input_specs(jc.shape), tm.input_specs(tc.shape)
            assert set(jin) == set(tin), where
            for name in jin:
                if name == "cache":
                    jcache = _jflat(jin["cache"])
                    tcache = _tflat(tin["cache"])
                    assert {k: (tuple(v.shape), str(v.dtype))
                            for k, v in jcache.items()} == \
                        {k: (tuple(v.shape), _dtype(v.dtype))
                         for k, v in tcache.items()}, where
                    assert all(v.device.type == "meta"
                               for v in tcache.values())
                    jcs = _jflat(jcells.cache_pspecs(jc, jin["cache"]))
                    tcs = _tflat(cells.cache_pspecs(tc, tin["cache"]))
                    assert {k: tuple(v) for k, v in jcs.items()} == tcs, where
                else:
                    shape_, dt = tin[name]
                    assert (shape_, _dtype(dt)) == \
                        (tuple(jin[name].shape), str(jin[name].dtype)), where


def test_default_rules_and_logical_to_spec():
    for kw in ({}, {"multi_pod": True}, {"fsdp": False},
               {"sequence_parallel": True, "shard_kv_seq": True},
               {"fold_axis": "data"}):
        jr, tr = jsharding.default_rules(**kw), sharding.default_rules(**kw)
        assert tr.rules == jr.rules
        for axes in (("batch", "seq", "embed_act"),
                     ("batch", "logits_seq", "vocab"), ("seq", "vocab"),
                     ("experts", "batch"), ("kv_seq", "heads", None)):
            assert sharding.logical_to_spec(axes, tr) == \
                tuple(jsharding.logical_to_spec(axes, jr))


def test_paramdef_axes_on_every_leaf():
    """No leaf of any arch's schema is missing its axes (a test, not a
    default, keeps them complete)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for arch in ARCHS:
        missing = []
        map_schema(lambda p, d: missing.append(p)
                   if d.axes is None or len(d.axes) != len(d.shape) else None,
                   Model.schema_of(get_config(arch)))
        assert not missing, (arch, missing)


# -- the ports of tests/test_sharding.py -------------------------------------

def _check_divisible(shape, spec, where):
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for dim, p in zip(shape, parts):
        if p is None:
            continue
        n = 1
        for a in (p if isinstance(p, tuple) else (p,)):
            n *= AXIS_SIZE[a]
        assert dim % n == 0, f"{where}: dim {dim} not divisible by {n} ({spec})"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_all_cells_shardable(multi_pod):
    for arch in ARCH_IDS:
        for shape in tconfig.SHAPES:
            cell = cells.make_cell(arch, shape.name, multi_pod=multi_pod)
            model = cell.model()
            if not model.supports_shape(shape)[0]:
                continue
            specs = _tflat(model.param_specs(cell.rules))
            map_schema(lambda p, d: _check_divisible(
                d.shape, specs[p], f"{cell.name} param"), model.schema())
            inputs = model.input_specs(shape)
            if shape.kind in ("train", "prefill"):
                ps = cells.batch_pspecs(cell)
                for k, (shp, _) in inputs.items():
                    _check_divisible(shp, ps[k], f"{cell.name} input {k}")
            else:
                sp = _tflat(cells.cache_pspecs(cell, inputs["cache"]))
                for k, leaf in _tflat(inputs["cache"]).items():
                    _check_divisible(leaf.shape, sp[k], f"{cell.name} cache")


def test_dedup_under_sequence_parallel():
    cell = cells.make_cell("granite-3-2b", "train_4k")
    assert sharding.logical_to_spec(("batch", "logits_seq", "vocab"),
                                    cell.rules) == P("data", None, "model")
    assert sharding.logical_to_spec(("batch", "seq", "embed_act"),
                                    cell.rules) == P("data", "model", None)


def test_head_indivisible_archs_fall_back():
    cell = cells.make_cell("yi-34b", "train_4k")
    assert cell.rules.get("heads") is None
    assert cell.rules.get("attn_seq") == "model"
    cell2 = cells.make_cell("granite-3-2b", "train_4k")
    assert cell2.rules.get("heads") == "model"
    assert cell2.rules.get("attn_seq") is None


def test_moe_expert_parallel_over_dp():
    assert cells.make_cell("deepseek-v3-671b",
                           "train_4k").rules.get("experts") == "data"
    assert cells.make_cell("deepseek-v3-671b", "decode_32k",
                           multi_pod=True).rules.get("experts") == \
        ("pod", "data")


def test_long_context_cache_spec():
    cell = cells.make_cell("zamba2-1.2b", "long_500k")
    inputs = cell.model().input_specs(cell.shape)
    sp = cells.cache_pspecs(cell, inputs["cache"])
    assert sp["attn"]["k"][2] == "data"


# -- outside and inside a mesh ------------------------------------------------

def test_constrain_is_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4)
    rules = sharding.default_rules()
    assert sharding.constrain(x, ("batch", "seq", "embed_act"), None) is x
    assert sharding.constrain(x, ("batch", "seq", "embed_act"), rules) is x
    assert sharding.active_mesh() is None


def test_products_are_torch_on_plain_tensors_and_swap_nothing():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 4, 5, generator=g), torch.randn(5, 6, generator=g)
    c = torch.randn(3, 5, 2, generator=g)
    assert torch.equal(sharding.matmul(a, b), a @ b)
    assert torch.equal(sharding.matmul(a, b[:, 0]), a @ b[:, 0])
    assert torch.equal(sharding.bmm(a, c), torch.bmm(a, c))
    assert torch.equal(sharding.einsum("bsd,dh->bsh", a, b),
                       torch.einsum("bsd,dh->bsh", a, b))
    orig = (torch.einsum, torch.matmul, torch.bmm, torch.Tensor.__matmul__,
            torch.Tensor.matmul, torch.Tensor.bmm)
    with sharding.dtensor_ops():            # a run or a trace on a mesh
        assert (torch.einsum, torch.matmul, torch.bmm,
                torch.Tensor.__matmul__, torch.Tensor.matmul,
                torch.Tensor.bmm) == orig


_MESH_SCRIPT = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.sharding import P, NamedSharding
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    mesh = init_device_mesh("cpu", (2, 2, 4),
                            mesh_dim_names=("pod", "data", "model"))
    out = {}
    for name, spec in {"tuple": P(("pod", "data"), None, "model"),
                       "model_first": P("model", "data"),
                       "replicated": P(None, None),
                       "pod_only": P(None, "pod")}.items():
        out[name] = [repr(p) for p in NamedSharding(mesh, spec).placements]
    t = torch.arange(8 * 6 * 8, dtype=torch.float32).reshape(8, 6, 8)
    d = sh.distribute(t, NamedSharding(mesh, P(("pod", "data"), None,
                                               "model")))
    out["local_shape"] = list(d.to_local().shape)
    out["local_equal"] = bool(torch.equal(d.to_local(), t[:2, :, :2]))
    x = sh.distribute(torch.randn(4, 8, 6),
                      NamedSharding(mesh, P("data", None, None)))
    rules = sh.default_rules(multi_pod=True, sequence_parallel=True)
    with sh.mesh_context(mesh):
        y = sh.constrain(x, ("batch", "seq", "embed_act"), rules)
        out["constrained"] = [repr(p) for p in y.placements]
        z = torch.randn(4, 8, 6)
        out["plain_is_same"] = sh.constrain(z, ("batch",), rules) is z
    out["after_exit"] = sh.active_mesh() is None
    print(json.dumps(out))
""")


def test_spec_to_placements_on_a_fake_mesh():
    res = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["tuple"] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
    assert out["model_first"] == ["Replicate()", "Shard(dim=1)",
                                  "Shard(dim=0)"]
    assert out["replicated"] == ["Replicate()"] * 3
    assert out["pod_only"] == ["Shard(dim=1)", "Replicate()", "Replicate()"]
    assert out["local_shape"] == [2, 6, 2] and out["local_equal"]
    assert out["constrained"] == ["Shard(dim=0)", "Shard(dim=0)",
                                  "Shard(dim=1)"]
    assert out["plain_is_same"] and out["after_exit"]
