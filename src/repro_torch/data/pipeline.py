"""A prefetching host feed (the reference's ``data/pipeline.py``).

``ShardedFeed`` wraps a (step -> host batch) function: a background
thread builds the next ``depth`` batches while the device computes,
puts each tensor in pinned host memory and copies it to ``device`` with
``non_blocking=True``, so the copy overlaps the step that runs.  Batch s
is a pure function of s, so a run restarted at step s (``start_step``)
replays what a fresh run saw there.  With ``sharding=`` (a
``batch_sharding``) each tensor of a batch becomes a ``DTensor`` on the
mesh, its batch dim split over the data axes (every rank builds the
whole batch, so placing it moves nothing between ranks).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import NamedSharding, P, distribute

Tensor = torch.Tensor


class ShardedFeed:
    """An iterator of batches (dicts of tensors) on ``device`` (the card
    unless ``device="cpu"``; with ``sharding``, the mesh's device), built
    ahead on a thread and, with ``sharding``, placed under it."""

    def __init__(self, make_batch: Callable[[int], Dict[str, Tensor]], *,
                 device: DeviceLike = None, start_step: int = 0,
                 depth: int = 2, sharding: Optional[NamedSharding] = None):
        self._make_batch = make_batch
        self._sharding = sharding
        if sharding is not None:
            device = ("cpu" if sharding.mesh.device_type == "cpu" else
                      torch.device("cuda", torch.cuda.current_device()))
        self._device = resolve_device(device)
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if self._device.type != "cuda":
            out = {k: v.to(self._device) for k, v in batch.items()}
        else:
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in batch.items()}
        if self._sharding is None:
            return out
        return {k: distribute(v, self._sharding) for k, v in out.items()}

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._place(self._make_batch(step)))
            except Exception as e:   # surfaced to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self) -> Iterator[Dict[str, Tensor]]:
        return self

    def __next__(self) -> Dict[str, Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        self._step = step + 1
        return batch

    @property
    def step(self) -> int:
        """The next step the consumer will receive (checkpoint this)."""
        return self._step

    def close(self) -> None:
        """Stop the worker and join it."""
        self._stop.set()
        self._thread.join(timeout=5)


def batch_sharding(mesh, multi_pod: bool = False) -> NamedSharding:
    """The batch dim over the mesh's data axes: ("pod", "data") with
    ``multi_pod`` on a mesh that has a "pod" axis, else "data"."""
    names = tuple(mesh.mesh_dim_names)
    dp = ("pod", "data") if multi_pod and "pod" in names else "data"
    return NamedSharding(mesh, P(dp))
