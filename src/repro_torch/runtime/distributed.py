"""Row-sharded moment reduction over ``torch.distributed`` — the data mesh.

The paper's deployment is data parallelism over a Ray cluster: rows
stay where they land, each worker reduces its rows to Gram-shaped
sufficient statistics, and only those fixed-size accumulators cross the
wire.  Every estimator of the port bottoms out in such accumulators
(``core.moments``, ``kernels.seg_gram``), so the mesh is a process group
of ``n_hosts × n_devices`` ranks, one shard each.  Every rank runs the
same program on the same arrays: a blocked reduction inside
``use_data_mesh`` evaluates the rank's own row blocks only, then meets
the other ranks in one collective — so the estimators run under a mesh
with no code of their own.

Contracts
---------
``reduction="ordered"`` (default)  rows pad to ``row_block``-sized
    blocks, and the block count rounds up to a multiple of the shard
    count; rank r evaluates ``block_fn`` on its contiguous range of
    blocks, one ``all_gather`` of the stacked partials follows, and every
    rank left-folds all of them in global block order from ``init`` (or
    zeros).  That is the addition sequence of ``blocked_reduce``'s
    chunked and whole strategies, so the result is bitwise theirs at any
    rank count.  The extra all-padding blocks contribute +0.0 under
    ``block_fn``'s zero-row contract.
``reduction="psum"``  each rank folds its own partials, one
    ``all_reduce(SUM)`` combines them, and ``init`` is added after: one
    accumulator per rank crosses instead of every block's, but the order
    of the additions differs, so it agrees with the chunked path to a
    tolerance only.

Backends and devices are named, never guessed: the group's backend is
the one it was initialized with, and the mesh's device is the caller's
(the card unless ``device="cpu"``).  NCCL needs a card of its own per
rank — two ranks on one device raise when the mesh is built.  gloo
reduces host tensors, so a gloo mesh over CUDA tensors copies the
partials to host memory for the collective and back: accumulators of at
most nb·S·qL·qR floats, never rows.  ``TRAFFIC`` counts the accumulator
bytes that enter the collectives (all ranks') and the bytes this rank
staged through the host.

Differences from the reference (``src/repro/runtime/distributed.py``):
the mesh is a process group, not one process's ``jax.sharding.Mesh``;
the collective runs when the reduction is called, not when it is
traced; a (1, 1) mesh without a group runs the same blocks and fold with
no collective; and the shard_map executor suspends the mesh inside its
replicates (``no_data_mesh``): each rank maps other replicates, whose
rows must not be pooled.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import socket
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.moments import _block
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
REDUCTIONS = ("ordered", "psum")
BACKENDS = ("nccl", "gloo")

# accumulator "bytes" that entered a collective (every rank's share),
# "staged_bytes" this rank copied between the card and the host
TRAFFIC: collections.Counter = collections.Counter()


class ShardLostError(RuntimeError):
    """A shard died (or was injected dead) during a distributed
    reduction: the runtime's ladder reruns the chunk single-host."""


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A row-sharding mesh: ``n_hosts × n_devices`` ranks of ``group``,
    this process being ``rank``; ``group`` None is the one-process (1, 1)
    mesh, which runs no collective."""

    group: Any
    rank: int
    n_hosts: int
    n_devices: int
    device: torch.device
    backend: Optional[str]           # "nccl" | "gloo"; None without a group
    reduction: str = "ordered"       # "ordered" (bitwise) | "psum"

    @property
    def n_shards(self) -> int:
        """Ranks the rows split over."""
        return self.n_hosts * self.n_devices

    @property
    def label(self) -> str:
        """``"<hosts>x<devices>:<reduction>"``, as the reference's."""
        return f"{self.n_hosts}x{self.n_devices}:{self.reduction}"


def _card_ids(group, dev: torch.device) -> List[str]:
    """(host, card) of every rank of ``group``, through a gloo side group
    of the same ranks (an NCCL collective is what cannot run yet)."""
    ranks = dist.get_process_group_ranks(group)
    side = dist.new_group(ranks, backend="gloo",
                          use_local_synchronization=True)
    props = torch.cuda.get_device_properties(dev)
    mine = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    ids: List[Any] = [None] * len(ranks)
    dist.all_gather_object(ids, mine, group=side)
    dist.destroy_process_group(side)
    return ids


def make_data_mesh(n_hosts: int = 0, n_devices: int = 0, *, group=None,
                   backend: Optional[str] = None, device: DeviceLike = None,
                   reduction: str = "ordered") -> DataMesh:
    """A DataMesh over ``group`` (default: the initialized default group,
    one host row per rank; without one, the (1, 1) mesh — the same code
    path with no parallelism).  ``n_hosts × n_devices`` must be the
    group's size: more raises, and a smaller mesh takes a group of its
    own (``torch.distributed.new_group``).  ``backend`` checks the
    group's; ``device`` is where the partials live (the card unless
    ``"cpu"``)."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r} "
                         "(expected ordered | psum)")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected nccl | gloo)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    h = int(n_hosts) or size
    d = int(n_devices) or max(1, size // h)
    if h * d > size:
        raise RuntimeError(f"data mesh ({h}, {d}) needs {h * d} ranks but "
                           f"the process group has {size}")
    if h * d < size:
        raise ValueError(f"data mesh ({h}, {d}) spans {h * d} of the group's "
                         f"{size} ranks: build a group of {h * d} ranks "
                         "(torch.distributed.new_group) and pass group=")
    if group is None:
        if backend is not None:
            raise ValueError(f"backend {backend!r} needs an initialized "
                             "process group")
        return DataMesh(None, 0, h, d, dev, None, reduction)
    actual = dist.get_backend(group)
    if actual not in BACKENDS or (backend is not None and backend != actual):
        raise ValueError(f"the process group runs {actual!r}"
                         + (f", not {backend!r}" if backend else "")
                         + " (expected nccl | gloo)")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the mesh's group")
    if actual == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"nccl reduces CUDA tensors, not {dev}; a "
                             "host mesh takes a gloo group")
        if size > 1:
            ids = _card_ids(group, dev)
            dup = next(((i, j) for i in range(size)
                        for j in range(i + 1, size) if ids[i] == ids[j]),
                       None)
            if dup is not None:
                raise RuntimeError(
                    f"nccl needs a card of its own per rank: ranks {dup[0]} "
                    f"and {dup[1]} share {ids[dup[0]]}; build the group "
                    "with gloo, which stages the accumulators through host "
                    "memory")
    return DataMesh(group, rank, h, d, dev, actual, reduction)


def check_data_mesh(dm: Any) -> Optional[DataMesh]:
    """``dm`` itself when it is a DataMesh or None; a TypeError else."""
    if dm is not None and not isinstance(dm, DataMesh):
        raise TypeError(f"data_mesh must be a DataMesh, got "
                        f"{type(dm).__name__}")
    return dm


# -- context-scoped activation (thread-local: job threads must not leak a
# -- mesh into each other's reductions) ---------------------------------------

_ACTIVE = threading.local()


def _stack() -> list:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


def current_data_mesh() -> Optional[DataMesh]:
    """The innermost active DataMesh (None outside ``use_data_mesh`` or
    inside ``no_data_mesh``).  Read by ``blocked_reduce`` and
    ``seg_reduce`` when they are called."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def _pushed(dm: Optional[DataMesh]) -> Iterator[Optional[DataMesh]]:
    stack = _stack()
    stack.append(dm)
    try:
        yield dm
    finally:
        stack.pop()


@contextlib.contextmanager
def use_data_mesh(dm: Optional[DataMesh]) -> Iterator[Optional[DataMesh]]:
    """Route every blocked moment reduction called inside through
    ``dist_reduce`` over ``dm``.  ``None`` is a no-op, so call sites can
    pass an optional mesh unconditionally."""
    if dm is None:
        yield None
        return
    with _pushed(dm):
        yield dm


def no_data_mesh():
    """Inside, no mesh is active (the shard_map executor's replicates)."""
    return _pushed(None)


# -- what every rank must agree on --------------------------------------------

def _object_device(dm: DataMesh):
    """Where ``broadcast_object_list`` stages its bytes: the card for
    nccl, the host for gloo."""
    return dm.device if dm.backend == "nccl" else None


def first_rank_writes(dm: Optional[DataMesh], write: Callable[[], Any]) -> Any:
    """Run ``write`` — a write to storage every rank shares, such as a
    checkpoint directory — on rank 0 of ``dm``'s group alone, then meet
    the other ranks: no two ranks race on one file, and no rank goes on
    before the write has landed.  A write that raised on rank 0 raises
    on every rank.  Returns ``write()``'s result on rank 0 and None on
    the others; without a mesh or a group, ``write()``."""
    if dm is None or dm.group is None:
        return write()
    out, msg = None, [None]
    if dm.rank == 0:
        try:
            out = write()
        except Exception as e:  # noqa: BLE001 — every rank raises it below
            msg[0] = f"{type(e).__name__}: {e}"
    dist.broadcast_object_list(msg, src=dist.get_global_rank(dm.group, 0),
                               group=dm.group, device=_object_device(dm))
    if msg[0] is not None:
        raise RuntimeError(f"rank 0's write failed: {msg[0]}")
    return out


def agree_min(dm: Optional[DataMesh], value: int) -> int:
    """The least ``value`` over ``dm``'s ranks (``value`` itself without
    a group): a chunk size every rank then maps with, so the ranks' maps
    meet in the same collectives."""
    if dm is None or dm.group is None:
        return int(value)
    x = torch.tensor([int(value)], dtype=torch.int64,
                     device=dm.device if dm.backend == "nccl" else "cpu")
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=dm.group)
    return int(x.item())


# -- deterministic failure injection (the lost-shard ladder rung) -------------

_FAIL_BUDGET = [0]


def inject_shard_failure(n: int = 1) -> None:
    """Arm the next ``n`` distributed reductions of this process to raise
    ``ShardLostError`` before they run — a deterministic stand-in for a
    dead worker (every rank arms its own, so the ranks fail together).
    ``inject_shard_failure(0)`` disarms.  The budget is one per process,
    not per thread: armed on the main thread, it strikes the next
    reduction of any thread, a job's thread included."""
    _FAIL_BUDGET[0] = int(n)


def _maybe_fail() -> None:
    if _FAIL_BUDGET[0] > 0:
        _FAIL_BUDGET[0] -= 1
        raise ShardLostError("injected shard failure (inject_shard_failure)")


# -- trees of tensors (a tensor or nested tuples, as block functions return) --

def _leaves(tree) -> List[Tensor]:
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, tuple):
        return tuple(_rebuild(t, it) for t in tree)
    return next(it)


# -- collectives --------------------------------------------------------------

def _staged(dm: DataMesh, x: Tensor) -> bool:
    """Whether ``x`` crosses the group through host memory (gloo)."""
    return dm.backend == "gloo" and x.device.type == "cuda"


def _host(shape, like: Tensor) -> Tensor:
    """A pinned host buffer: the copies to and from the card run at the
    bus's rate, and the caching host allocator keeps it for the next
    call."""
    return torch.empty(shape, dtype=like.dtype, pin_memory=True)


def _count(dm: DataMesh, w: Tensor, staged: int) -> None:
    TRAFFIC["bytes"] += dm.n_shards * w.numel() * w.element_size()
    TRAFFIC["staged_bytes"] += staged


def all_gather_rows(dm: DataMesh, x: Tensor) -> Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along the
    leading axis in rank order; ``x`` itself on a mesh without a group."""
    if dm.group is None:
        return x
    x = x.contiguous()
    shape = (dm.n_shards,) + tuple(x.shape)
    if _staged(dm, x):
        w, out = _host(x.shape, x).copy_(x), _host(shape, x)
    else:
        w, out = x, torch.empty(shape, dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), w, group=dm.group)
    out = out.reshape((-1,) + tuple(x.shape[1:]))
    staged = 0
    if out.device != x.device:
        staged = (w.numel() + out.numel()) * w.element_size()
        out = out.to(x.device)
    _count(dm, w, staged)
    return out


def _all_reduce_sum(dm: DataMesh, x: Tensor) -> Tensor:
    if dm.group is None:
        return x
    x = x.contiguous()
    w = _host(x.shape, x).copy_(x) if _staged(dm, x) else x
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=dm.group)
    staged = 0
    if w.device != x.device:
        staged = 2 * w.numel() * w.element_size()
        w = w.to(x.device)
    _count(dm, w, staged)
    return w


def _check_device(dm: DataMesh, arrays: Sequence[Tensor]) -> None:
    for a in arrays:
        if a.device.type != dm.device.type or (
                a.device.type == "cuda" and a.device.index != dm.device.index):
            raise ValueError(f"the mesh reduces on {dm.device}, but an "
                             f"input lies on {a.device}")


def dist_reduce(block_fn: Callable[..., Any], arrays: Sequence[Tensor], *,
                row_block: int, dm: Optional[DataMesh] = None,
                pad_values: Optional[Sequence] = None,
                init: Optional[Any] = None,
                reduction: Optional[str] = None) -> Any:
    """Row-sharded ``blocked_reduce``: ``row_block``-sized blocks of the
    leading axis split over ``dm``'s ranks (default: the active mesh),
    ``block_fn`` per block on each rank, the fixed-size partials combined
    across the group.

    ``block_fn``'s contract is blocked_reduce's: it returns a tensor or a
    tuple of tensors, is row-additive, and maps padded rows to exact
    zeros; ``pad_values`` pins per-array padding constants (-1 fold ids);
    ``init`` seeds the fold.  ``reduction`` overrides the mesh's."""
    dm = dm if dm is not None else current_data_mesh()
    if dm is None:
        raise ValueError("dist_reduce needs a DataMesh (pass dm= or enter "
                         "use_data_mesh)")
    mode = reduction or dm.reduction
    if mode not in REDUCTIONS:
        raise ValueError(f"unknown reduction {mode!r} "
                         "(expected ordered | psum)")
    r = int(row_block)
    if r <= 0:
        raise ValueError("dist_reduce requires row_block > 0")
    arrays = tuple(arrays)
    n = arrays[0].shape[0]
    if n == 0:
        raise ValueError("dist_reduce needs at least one row")
    _check_device(dm, arrays)
    _maybe_fail()
    S = dm.n_shards
    m = -(-(-(-n // r)) // S)             # blocks per rank
    pv = tuple(pad_values or (0,) * len(arrays))
    lo = dm.rank * m
    parts = [block_fn(*[_block(a, i, r, v) for a, v in zip(arrays, pv)])
             for i in range(lo, lo + m)]
    shape = parts[0]
    stacked = [torch.stack(ls) for ls in zip(*map(_leaves, parts))]
    if mode == "ordered":
        everything = [all_gather_rows(dm, x) for x in stacked]
        acc = ([torch.zeros_like(x[0]) for x in stacked] if init is None
               else _leaves(init))
        for i in range(S * m):
            acc = [torch.add(a, x[i]) for a, x in zip(acc, everything)]
        return _rebuild(shape, iter(acc))
    local = [torch.zeros_like(x[0]) for x in stacked]
    for i in range(m):
        local = [torch.add(a, x[i]) for a, x in zip(local, stacked)]
    out = [_all_reduce_sum(dm, x) for x in local]
    if init is not None:
        out = [torch.add(a, x) for a, x in zip(_leaves(init), out)]
    return _rebuild(shape, iter(out))
