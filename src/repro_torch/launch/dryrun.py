"""Multi-pod dry run: every (architecture × input-shape) cell traced on
the production mesh — single-pod (16, 16) = 256 ranks and multi-pod
(2, 16, 16) = 512 ranks — with its per-device cost, roofline and memory
(the reference's ``launch/dryrun.py``).

No card and no cluster are needed: the process opens a "fake" default
group of 512 ranks (``torch.testing._internal.distributed.
fake_pg``) and runs the cell's entry point once, as rank 0, under
``FakeTensorMode`` (fake CPU tensors: shapes and dtypes, no memory, the
plain routes of every op).  The parameters, the AdamW state and the
inputs are ``DTensor``s placed by the cell's shardings
(``Model.param_shardings``, ``launch/cells.cell_input_shardings``), and
the model's ``constrain`` calls redistribute the activations inside
``mesh_context``.  ``launch/op_cost.count`` counts what rank 0 runs:
local ops on its shards and the collectives.  A sharding mismatch or an
op with no sharding rule fails the cell, which is reported with
``status: "error"``; the sweep goes on and the exit code is 1.

Entry points: the train step (``launch/train.make_train_step``) for
train_*, ``Model.prefill`` for prefill_*, ``Model.decode_step`` against
a cache of seq_len positions for decode_* and long_500k.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paper-cell \\
        --mesh both --json out.jsonl

``--paper-cell`` runs the paper's 2^20 x 500 DML fit instead
(``run_dml_cell``, engines "parallel" and "parallel_loo"): its inputs
row-sharded over every rank (``launch/dml_cell.row_sharding``), each
rank's moments passes on its rows summed by all-reduces.

Each cell prints one line and, with ``--json``, appends one record.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.config import SHAPES, TrainConfig
from repro_torch.configs import ARCH_IDS
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              distribute, dtensor_ops,
                                              mesh_context)
from repro_torch.launch import op_cost
from repro_torch.launch.cells import Cell, cell_input_shardings, make_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline, model_flops_for
from repro_torch.models.params import flatten


def _open_group() -> None:
    """A fake default group of 512 ranks, this process rank 0: the
    multi-pod mesh takes them all and the single pod the first 256 (one
    group for both: a group destroyed and opened again would leave
    DTensor's caches naming the old one's subgroups)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=512,
                                store=FakeStore())


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in flatten(tree).values():
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _place_params(model, cell: Cell, mesh) -> Dict[str, Any]:
    """Replace every weight of ``model`` by a DTensor under the cell's
    param shardings; returns {state_dict path: NamedSharding}."""
    from torch import nn
    shard = flatten(model.param_shardings(cell.rules, mesh))
    for path, sh in shard.items():
        *mods, leaf = path.split(".")
        owner = model
        for m in mods:
            owner = getattr(owner, m)
        owner._parameters[leaf] = nn.Parameter(
            distribute(owner._parameters[leaf].detach(), sh),
            requires_grad=False)
    return shard


def _inputs(cell: Cell, model, mesh):
    """The entry point's inputs as DTensors: tokens / labels zeros,
    activations zeros, the decode cache ``init_cache`` zeros."""
    specs, shard = cell_input_shardings(cell, mesh)
    out: Dict[str, Any] = {}
    for name, spec in specs.items():
        if name == "cache":
            cache = model.init_cache(cell.shape.global_batch,
                                     cell.shape.seq_len, device="cpu")
            out[name] = _distribute_tree(cache, shard[name])
        elif name == "pos":
            out[name] = 0
        else:
            shape, dtype = spec
            out[name] = distribute(torch.zeros(shape, dtype=dtype),
                                   shard[name])
    return out


def _distribute_tree(tree, shardings):
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings)


def _run_entry(cell: Cell, model, mesh, param_sh, inputs,
               tcfg: TrainConfig):
    """(argument bytes of this rank, a thunk running the entry point)."""
    kind = cell.shape.kind
    if kind == "train":
        from repro_torch.launch.train import make_train_step
        params = dict(model.state_dict())
        mdt = model.parallel.adam_moment_dtype
        opt = {"step": distribute(torch.zeros((), dtype=torch.int32),
                                  NamedSharding(mesh, P())),
               "m": {k: distribute(torch.zeros(p.shape, dtype=mdt),
                                   param_sh[k]) for k, p in params.items()},
               "v": {k: distribute(torch.zeros(p.shape, dtype=mdt),
                                   param_sh[k]) for k, p in params.items()}}
        step = make_train_step(model, tcfg)
        args = _local_bytes(params) + _local_bytes(opt["m"]) + \
            _local_bytes(opt["v"]) + _local_bytes(inputs)
        return args, lambda: step(params, opt, inputs)
    args = _local_bytes(dict(model.state_dict())) + _local_bytes(
        {k: v for k, v in inputs.items() if k != "pos"})
    if kind == "prefill":
        return args, lambda: model.prefill(**inputs)
    return args, lambda: model.decode_step(inputs["tokens"], inputs["cache"],
                                           inputs["pos"])


@contextlib.contextmanager
def relaxed_views():
    """Let a view that splits or merges a sharded dim unevenly
    redistribute its input first, as a reshape does.  The train step's
    microbatch split views the batch (256, S), sharded 16 ways, as
    (8, 32, S) for the MoE giants' 8 microbatches: a split whose leading
    dim the mesh does not divide, which DTensor refuses for a view and
    would fail the cell."""
    try:
        from torch.distributed.tensor._ops import _view_ops as vo
        orig = vo.propagate_shape_and_sharding
    except (ImportError, AttributeError):
        yield
        return

    def non_strict(*args, **kwargs):
        kwargs["strict_view"] = False
        return orig(*args[:4], **kwargs)

    vo.propagate_shape_and_sharding = non_strict
    try:
        yield
    finally:
        vo.propagate_shape_and_sharding = orig


@contextlib.contextmanager
def mesh_alltoall():
    """Change which dim a DTensor is sharded on by an all-to-all, as on
    the cards' mesh: DTensor otherwise falls back to an all-gather and a
    chunk on a mesh of device type "cpu" (gloo has no all-to-all), which
    would count a whole tensor's gather where a card moves 1/G of it."""
    try:
        from torch.distributed._functional_collectives import (
            _group_or_group_name, _resolve_group)
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import _redistribute as rd
        from torch.distributed.tensor import placement_types as pt
        orig = cu.shard_dim_alltoall
    except (ImportError, AttributeError):
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = _resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _group_or_group_name(group))

    mods = [m for m in (cu, rd, pt) if getattr(m, "shard_dim_alltoall", None)
            is orig]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = orig


def trace_cell(cell: Cell, mesh, tcfg: TrainConfig = TrainConfig()):
    """(CostTotals, argument bytes, parameter bytes) of one run of the
    cell's entry point as rank 0 of ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), dtensor_ops(), mesh_context(mesh), \
            relaxed_views(), mesh_alltoall():
        model = cell.model(device="cpu")
        param_sh = _place_params(model, cell, mesh)
        param_bytes = _local_bytes(dict(model.state_dict()))
        inputs = _inputs(cell, model, mesh)
        args, run = _run_entry(cell, model, mesh, param_sh, inputs, tcfg)
        with op_cost.count() as totals:
            run()
    return totals, args, param_bytes


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> Dict[str, Any]:
    t0 = time.time()
    cell = make_cell(arch, shape_name, multi_pod=multi_pod)
    ok, why = cell.model().supports_shape(cell.shape)
    chips = 512 if multi_pod else 256
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod), "chips": chips}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    _open_group()
    mesh = make_production_mesh(multi_pod=multi_pod)
    tot, args, param_bytes = trace_cell(cell, mesh)
    _record(rec, tot, args, model_flops_for(cell.cfg, cell.shape), t0,
            verbose, param_bytes=int(param_bytes))
    return rec


def _record(rec: Dict[str, Any], tot, args: int, model_flops: float,
            t0: float, verbose: bool, **memory) -> None:
    """Fill ``rec`` with the reference's cost keys from a traced step's
    ``CostTotals`` ``tot`` and its argument bytes, and print its line."""
    rl = Roofline(flops=tot.flops, hbm_bytes=tot.bytes,
                  wire_bytes=tot.wire_bytes, model_flops=model_flops,
                  chips=rec["chips"])
    mem = {"argument_bytes": int(args), **memory,
           "peak_bytes": int(args) + int(tot.peak_bytes),
           "peak_top": tot.peak_top}
    rec.update(
        status="ok",
        flops_per_chip=rl.flops,
        hbm_bytes_per_chip=rl.hbm_bytes,
        wire_bytes_per_chip=rl.wire_bytes,
        collective_count=tot.coll_count,
        collective_by_op={k: float(v) for k, v in tot.coll_by_op.items()},
        model_flops=rl.model_flops,
        t_compute=rl.t_compute, t_memory=rl.t_memory,
        t_collective=rl.t_collective,
        bottleneck=rl.bottleneck, step_time=rl.step_time,
        useful_frac=rl.useful_flops_frac, mfu_bound=rl.mfu_bound,
        memory=mem, lower_s=round(time.time() - t0, 1),
    )
    if verbose:
        print(f"[{rec['mesh']}] {rec['arch']}/{rec['shape']}: "
              f"bottleneck={rl.bottleneck} step>={rl.step_time * 1e3:.1f}ms "
              f"mfu_bound={rl.mfu_bound:.2%} "
              f"peak_mem={mem['peak_bytes'] / 2**30:.2f}GiB "
              f"(traced in {rec['lower_s']}s)", flush=True)


def run_dml_cell(*, multi_pod: bool, verbose: bool = True, n: int = 0,
                 p: int = 0, engine: str = "parallel") -> Dict[str, Any]:
    """The paper's own 2^20 x 500 fold-parallel DML fit on the mesh
    (``launch/dml_cell.lower_dml_cell``): rows over every rank, each
    rank's moments passes on its rows and their all-reduces."""
    from repro_torch.launch import dml_cell
    t0 = time.time()
    nn, pp = n or dml_cell.N_ROWS, p or dml_cell.N_COVARIATES
    chips = 512 if multi_pod else 256
    rec: Dict[str, Any] = {"arch": f"dml-crossfit-{engine}",
                           "shape": f"{nn}rows",
                           "mesh": _mesh_name(multi_pod), "chips": chips}
    _open_group()
    mesh = make_production_mesh(multi_pod=multi_pod)
    tot, args = dml_cell.lower_dml_cell(mesh, n=nn, p=pp, engine=engine)
    # useful model flops: the reference's count of the two nuisances'
    # Gram / Newton passes and the final stage (its "rough" formula)
    _record(rec, tot, args, 2.0 * 5 * nn * pp * pp * (1 + 16) / 4, t0,
            verbose)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper-cell", action="store_true",
                    help="the paper's 2^20 x 500 DML fit on the mesh, both "
                         "engines, instead of the LM cells")
    ap.add_argument("--n", type=int, default=0,
                    help="--paper-cell rows (default 2^20)")
    ap.add_argument("--p", type=int, default=0,
                    help="--paper-cell covariates (default 500)")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.paper_cell:
        from repro_torch.launch.dml_cell import N_ROWS
        runs = [(f"dml-crossfit-{e}", f"{args.n or N_ROWS}rows", mp,
                 lambda mp=mp, e=e: run_dml_cell(multi_pod=mp, n=args.n,
                                                 p=args.p, engine=e))
                for mp in meshes for e in ("parallel", "parallel_loo")]
    else:
        archs = (list(ARCH_IDS) if (args.all or not args.arch)
                 else [args.arch])
        shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
                  else [args.shape])
        runs = [(arch, shape, mp, lambda mp=mp, a=arch, s=shape:
                 run_cell(a, s, multi_pod=mp))
                for mp in meshes for arch in archs for shape in shapes]

    out = open(args.json, "a") if args.json else None
    failed = 0
    for arch, shape, mp, run in runs:
        try:
            rec = run()
        except Exception as e:  # a sharding bug — report, go on
            failed += 1
            rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {arch}/{shape}: {e!r}"[:2000], file=sys.stderr,
                  flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
