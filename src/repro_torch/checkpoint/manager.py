"""Atomic, asynchronous checkpointing of nested dicts of tensors.

  * **Atomic**: state is written to ``<dir>/tmp.<step>.<pid>`` and
    renamed to ``<dir>/step_<step>`` only after a full fsync'd write — a
    crash mid-save never corrupts the latest checkpoint.
  * **Async**: ``save_async`` copies every tensor to host memory first
    (torch tensors are mutable: a caller may update a state in place
    after the call returns), then serializes in a background thread.
  * **Retention**: keeps the newest ``keep_latest`` checkpoints plus the
    ``keep_best`` lowest-metric ones.

Format: one ``arrays.npz`` holding leaves keyed by their path in the
nested dict ("a/b/c") + ``meta.json`` (step, metric, user metadata).
``restore`` matches leaves to a caller-provided template by path and
shape, so a changed state layout fails loudly instead of misloading;
the template's tensors may be on the ``meta`` device (shape and dtype
only).

Meshes: the format holds no placement.  ``save`` of a state whose leaves
are ``DTensor``s gathers each leaf whole (``full_tensor``) on every
rank; rank 0 of the default group writes and the others wait until the
write has landed (an error on rank 0 raises on every rank).
``restore(shardings=)`` places each leaf under its ``NamedSharding`` —
the reference's ``device_put`` — so a state saved on N ranks resumes on
M (``launch/elastic.elastic_restore``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tensor leaves of nested dicts keyed by "a/b/c" paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _host_copy(tree):
    """The same nested dict with every tensor copied to host memory, a
    ``DTensor`` gathered whole first (a collective its mesh's ranks
    join)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().to("cpu", copy=True)


def _mesh_group(state):
    """The default group when ``state`` has ``DTensor`` leaves (its ranks
    share the save), else None."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    leaves = flatten_with_paths(state).values()
    return (dist.group.WORLD
            if any(isinstance(v, DTensor) for v in leaves) else None)


def _meet_rank0(group, error: Optional[BaseException]) -> None:
    """Every rank of ``group`` meets rank 0 after its write; rank 0's
    ``error`` (None if the write landed) raises on every rank."""
    import torch.distributed as dist
    msg = [None if error is None else f"{type(error).__name__}: {error}"]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else None)
    dist.broadcast_object_list(msg, src=dist.get_global_rank(group, 0),
                               group=group, device=dev)
    if error is not None:
        raise error
    if msg[0] is not None:
        raise RuntimeError(f"rank 0's checkpoint write failed: {msg[0]}")


def _sharding_device(sharding) -> torch.device:
    """Where a leaf under ``sharding`` lives: this rank's card on a CUDA
    mesh, else the host."""
    if sharding.mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(sharding.mesh.device_type)


def restore_tree(template, arrays: Dict[str, np.ndarray], *,
                 device=None, prefix: str = "", shardings=None):
    """Rebuild ``template``'s nested dicts from path-keyed arrays: each
    leaf takes its template tensor's dtype, and its device (``device``
    for a template on ``meta``, or when given).  With ``shardings`` (the
    template's nesting, a ``NamedSharding`` a leaf) each leaf becomes a
    ``DTensor`` under its sharding on the mesh's device."""
    if isinstance(template, dict):
        return {k: restore_tree(v, arrays, device=device,
                                prefix=f"{prefix}/{k}" if prefix else str(k),
                                shardings=None if shardings is None
                                else shardings[k])
                for k, v in template.items()}
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = arrays[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch at {prefix}: "
                         f"ckpt {arr.shape} vs template {tuple(template.shape)}")
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute
        t = torch.as_tensor(np.array(arr)).to(
            device=_sharding_device(shardings), dtype=template.dtype)
        return distribute(t, shardings)
    dev = device
    if dev is None:
        dev = "cpu" if template.device.type == "meta" else template.device
    return torch.as_tensor(np.array(arr)).to(device=dev, dtype=template.dtype)


class CheckpointManager:
    """Versioned snapshots in one directory: ``step_<step>`` each."""

    def __init__(self, directory: str, *, keep_latest: int = 2,
                 keep_best: int = 1):
        self.dir = directory
        self.keep_latest = keep_latest
        self.keep_best = keep_best
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None          # a DTensor save's group, met in wait()

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------
    def save(self, step: int, state, *, metric: Optional[float] = None,
             extra: Optional[Dict[str, Any]] = None):
        """Blocking save (used by save_async's worker).  ``DTensor``
        leaves: gathered on every rank, written by rank 0 alone, every
        rank back once the write has landed."""
        group = _mesh_group(state)
        if group is None:
            return self._write(step, state, metric, extra)
        import torch.distributed as dist
        host, error = _host_copy(state), None
        if dist.get_rank(group) == 0:
            try:
                self._write(step, host, metric, extra)
            except BaseException as e:  # noqa: BLE001 — raised on every rank
                error = e
        _meet_rank0(group, error)

    def _write(self, step: int, state, metric: Optional[float],
               extra: Optional[Dict[str, Any]]):
        host = {k: v.detach().cpu().numpy()
                for k, v in flatten_with_paths(state).items()}
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        try:
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **host)
                f.flush()
                os.fsync(f.fileno())
            meta = {"step": int(step), "metric": metric,
                    "time": time.time(), "extra": extra or {}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic commit
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._retain()

    def save_async(self, step: int, state, *, metric: Optional[float] = None,
                   extra: Optional[Dict[str, Any]] = None):
        """Copy to host now; serialize in the background.  A state of
        ``DTensor``s is gathered here on every rank and written by rank
        0; the next ``wait`` (every rank calls it) meets rank 0 there."""
        self.wait()  # one in-flight save at a time
        group = _mesh_group(state)
        host_state = _host_copy(state)
        self._group = group
        if group is not None:
            import torch.distributed as dist
            if dist.get_rank(group) != 0:
                return

        def work():
            try:
                self.save(step, host_state, metric=metric, extra=extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight async save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._group is not None:
            group, self._group = self._group, None
            _meet_rank0(group, err)
        elif err is not None:
            raise err

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------
    def _steps(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append((int(name.split("_")[1]),
                            os.path.join(self.dir, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest step on disk, or None."""
        steps = self._steps()
        return steps[-1][0] if steps else None

    def has_step(self, step: int) -> bool:
        """Whether ``step`` is on disk."""
        return any(s == step for s, _ in self._steps())

    def load(self, *, step: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """(path-keyed host arrays, meta) WITHOUT a template — for
        callers whose leaf set varies per step (the sweep engine's
        per-column checkpoints).  ``restore`` is the exact-template
        contract."""
        steps = dict(self._steps())
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = step if step is not None else max(steps)
        path = steps[step]
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return arrays, meta

    def restore(self, template, *, step: Optional[int] = None, device=None,
                shardings=None) -> Tuple[Any, Dict[str, Any]]:
        """(state shaped like ``template``, meta) of ``step`` (latest if
        None); with ``shardings`` (nested as ``template``) every leaf a
        ``DTensor`` placed under its ``NamedSharding``."""
        arrays, meta = self.load(step=step)
        return restore_tree(template, arrays, device=device,
                            shardings=shardings), meta

    # ------------------------------------------------------------------
    # Retention
    # ------------------------------------------------------------------
    def _retain(self):
        steps = self._steps()
        if len(steps) <= self.keep_latest:
            return
        # newest keep_latest always survive
        protected = {s for s, _ in steps[-self.keep_latest:]}
        # plus the keep_best best-metric ones
        scored = []
        for s, p in steps:
            try:
                with open(os.path.join(p, "meta.json")) as f:
                    m = json.load(f).get("metric")
                if m is not None:
                    scored.append((m, s))
            except OSError:
                pass
        for _, s in sorted(scored)[: self.keep_best]:
            protected.add(s)
        for s, p in steps:
            if s not in protected:
                shutil.rmtree(p, ignore_errors=True)
