"""Executors — how the replicates of replicate inference run (the
single-card analogue of Ray's task pool).

A replicate function takes a 1-D tensor of replicate ids (a leading
batch) plus pass-through data arguments and returns a dict of tensors
whose leading axis is that batch.  An executor maps it over all ids:

  serial   one call per replicate, in turn — the EconML/Ray-less
           baseline;
  vmap     the replicate axis written out as a leading batch dimension
           (the reference's name: it vmaps there), in microbatches of
           ``microbatch`` replicates (all at once when unset): every
           weighted Gram of a microbatch is one kernel launch.

Both run the same function, so each replicate's arithmetic is the same
in both wherever its operations are batch-invariant (the kernel's
Grams, the elementwise solves, one mat-vec per fold).  ``shard_map``
waits for the multi-card slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Protocol

import torch

Tensor = torch.Tensor
ReplicateFn = Callable[..., Dict[str, Tensor]]


class Executor(Protocol):
    """Maps a replicate function over the leading axis of ``ids``;
    ``*args`` pass through to every call."""

    name: str

    def map(self, fn: ReplicateFn, ids: Tensor, *args: Any
            ) -> Dict[str, Tensor]:
        ...


def _concat(outs: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


@dataclasses.dataclass
class SerialExecutor:
    """One call per replicate, strictly in turn."""

    name: str = "serial"

    def map(self, fn: ReplicateFn, ids: Tensor, *args: Any
            ) -> Dict[str, Tensor]:
        """Replicate-ordered outputs of ``fn`` on each id alone."""
        return _concat([fn(ids[i:i + 1], *args) for i in range(len(ids))])


@dataclasses.dataclass
class BatchedExecutor:
    """The replicate axis as a leading batch dimension, ``microbatch``
    replicates per call (None or 0: all in one call).  The microbatch
    bounds memory: every weighted Gram's split-partial buffer and every
    batched solve grow linearly in it."""

    microbatch: Optional[int] = None
    name: str = "vmap"

    def map(self, fn: ReplicateFn, ids: Tensor, *args: Any
            ) -> Dict[str, Tensor]:
        """Replicate-ordered outputs of ``fn`` on chunks of ids."""
        c = self.microbatch or len(ids)
        return _concat([fn(ids[i:i + c], *args)
                        for i in range(0, len(ids), c)])


def make_executor(name, *, microbatch: Optional[int] = None) -> Executor:
    """``serial`` | ``vmap`` (``microbatch`` replicates per call); an
    executor object passes through."""
    if not isinstance(name, str):
        return name
    if name == "serial":
        return SerialExecutor()
    if name == "vmap":
        return BatchedExecutor(microbatch=microbatch)
    if name == "shard_map":
        raise NotImplementedError(
            "the shard_map executor spreads replicates over several cards; "
            "it lands with the multi-card slice (ROADMAP A.10)")
    raise ValueError(f"unknown executor {name!r} "
                     "(expected serial | vmap | shard_map)")
