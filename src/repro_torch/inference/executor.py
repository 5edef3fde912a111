"""Executors — how the replicates of replicate inference run (the
single-card analogue of Ray's task pool).

A replicate function takes a tree of tensors that share a leading
replicate axis (a dict, list or tuple of tensors, or one tensor — the
bootstrap's 1-D ``ids`` is a one-leaf tree; the sweep's cells map
``{"key", "sid"}``) plus pass-through data arguments, and returns a tree
of tensors whose leading axis is that batch.  An executor maps it over
the whole axis, slicing every input leaf and concatenating every output
leaf:

  serial   one call per replicate, in turn — the EconML/Ray-less
           baseline;
  vmap     the replicate axis written out as a leading batch dimension
           (the reference's name: it vmaps there), in microbatches of
           ``microbatch`` replicates (all at once when unset): every
           weighted Gram of a microbatch is one kernel launch;
  shard_map  the replicate axis split into contiguous chunks over the
           ranks of a data mesh (``runtime.distributed.DataMesh``), each
           rank mapping its chunk as ``vmap`` does, one ``all_gather``
           returning every chunk in replicate order.

All run the same function, so each replicate's arithmetic is the same
in all wherever its operations are batch-invariant (the kernel's
Grams, the elementwise solves, one mat-vec per fold).
``repro_torch.runtime.TaskRuntime`` schedules executors: chunking, the
downgrade ladder, futures.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol

import torch

from repro_torch.pytree import (concat_trees, leading_dim,  # noqa: F401
                                slice_tree, tree_leaves, tree_map)

Tensor = torch.Tensor
ReplicateFn = Callable[..., Any]


class Executor(Protocol):
    """Maps a replicate function over the leading axis of ``xs``;
    ``*args`` pass through to every call."""

    name: str

    def map(self, fn: ReplicateFn, xs: Any, *args: Any) -> Any:
        ...


@dataclasses.dataclass
class SerialExecutor:
    """One call per replicate, strictly in turn."""

    name: str = "serial"

    def map(self, fn: ReplicateFn, xs: Any, *args: Any) -> Any:
        """Replicate-ordered outputs of ``fn`` on each replicate alone."""
        return concat_trees([fn(slice_tree(xs, i, i + 1), *args)
                             for i in range(leading_dim(xs))])


@dataclasses.dataclass
class BatchedExecutor:
    """The replicate axis as a leading batch dimension, ``microbatch``
    replicates per call (None or 0: all in one call).  The microbatch
    bounds memory: every weighted Gram's split-partial buffer and every
    batched solve grow linearly in it."""

    microbatch: Optional[int] = None
    name: str = "vmap"

    def map(self, fn: ReplicateFn, xs: Any, *args: Any) -> Any:
        """Replicate-ordered outputs of ``fn`` on chunks of replicates."""
        b = leading_dim(xs)
        c = self.microbatch or b
        return concat_trees([fn(slice_tree(xs, i, i + c), *args)
                             for i in range(0, b, c)])


@dataclasses.dataclass
class ShardMapExecutor:
    """The replicate axis split over ``mesh``'s ranks: padded to a
    multiple of the rank count (the padding replays replicate 0 and is
    dropped), rank r maps chunk r with the batched executor, and one
    ``all_gather`` a leaf returns the chunks in replicate order — so
    every rank holds every replicate.  Inside its chunk no data mesh is
    active: the rank's replicates are its own, so their rows must not be
    pooled with another rank's."""

    mesh: Any
    name: str = "shard_map"

    def map(self, fn: ReplicateFn, xs: Any, *args: Any) -> Any:
        """Replicate-ordered outputs of ``fn``, every rank's chunk."""
        from repro_torch.runtime.distributed import (all_gather_rows,
                                                     no_data_mesh)

        dm = self.mesh
        b = leading_dim(xs)
        c = -(-b // dm.n_shards)
        pad = c * dm.n_shards - b
        if pad:
            xs = tree_map(lambda x: torch.cat(
                [x, x[:1].expand((pad,) + tuple(x.shape[1:]))]), xs)
        lo = dm.rank * c
        with no_data_mesh():
            out = BatchedExecutor().map(fn, slice_tree(xs, lo, lo + c),
                                        *args)
        return tree_map(lambda y: all_gather_rows(dm, y)[:b], out)


# the reference's name for the batched executor (it vmaps there): one class
VmapExecutor = BatchedExecutor


def make_executor(name, *, microbatch: Optional[int] = None,
                  mesh=None) -> Executor:
    """``serial`` | ``vmap`` (``microbatch`` replicates per call) |
    ``shard_map`` over ``mesh`` (default: the active data mesh; raises
    without one); an executor object passes through."""
    if not isinstance(name, str):
        return name
    if name == "serial":
        return SerialExecutor()
    if name == "vmap":
        return BatchedExecutor(microbatch=microbatch)
    if name == "shard_map":
        if mesh is None:
            from repro_torch.runtime.distributed import current_data_mesh
            mesh = current_data_mesh()
        if mesh is None:
            raise ValueError("the shard_map executor splits replicates over "
                             "a DataMesh: pass mesh= or call inside "
                             "use_data_mesh")
        return ShardMapExecutor(mesh)
    raise ValueError(f"unknown executor {name!r} "
                     "(expected serial | vmap | shard_map)")
