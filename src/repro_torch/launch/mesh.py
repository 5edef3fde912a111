"""Production meshes (the reference's ``launch/mesh.py``) as
``torch.distributed.device_mesh.DeviceMesh``es over the default process
group.

Built by FUNCTIONS, never module constants, so importing this module
touches no process group.  The dry run (``launch/dryrun.py``) opens a
"fake" group of 512 ranks (``torch.testing._internal.distributed.
fake_pg.FakeStore``) for the production meshes; a run on cards opens an
NCCL group.  The mesh's device type is "cuda" on an NCCL group and
"cpu" on gloo or fake.
"""
from __future__ import annotations

import math

import torch.distributed as dist

SINGLE_POD = (16, 16)                  # 256 ranks
MULTI_POD = (2, 16, 16)                # 2 pods = 512 ranks


def _group_size() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mk(shape, axes):
    """A mesh of ``shape`` over the first prod(shape) ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(dev, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(data, model) = (16, 16), or (pod, data, model) = (2, 16, 16)
    with ``multi_pod``, over the first 256 / 512 ranks of a default group
    of 256 or 512 (the single pod on a 512-rank group: one group serves
    both meshes)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, world = math.prod(shape), _group_size()
    if world not in (256, 512) or world < n:
        raise RuntimeError(
            f"mesh {shape} needs a group of {n} (or 512) ranks but the "
            f"default group has {world}; the dry run opens a fake one: "
            f"init_process_group('fake', world_size=512, store=FakeStore()) "
            f"(torch.testing._internal.distributed.fake_pg)")
    return _mk(shape, axes)


def make_host_mesh():
    """(data, model) = (world, 1): every rank of the default group on the
    data axis."""
    return _mk((_group_size(), 1), ("data", "model"))


def make_causal_mesh(*, multi_pod: bool = False):
    """The DML engine's mesh: the production mesh, rows sharded over
    ("data", "model") jointly through the "rows" logical axis."""
    return make_production_mesh(multi_pod=multi_pod)
