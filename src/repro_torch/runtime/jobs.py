"""Minimal job-submission + event-stream API over sweeps — the Ray
job-server shape (submit / poll / subscribe) reproduced natively.

A ``SweepJob`` runs ``repro_torch.sweep.sweep`` on a background thread
(on the device the job names: the thread sets it explicitly instead of
relying on its own current device) and
streams one completion event per column into an ``EventLog`` ring
buffer (the same bounded structure the scheduler uses), so a client
can poll status cheaply, subscribe to per-column completions as they
land, and fetch the final ``EffectPanel`` when the job settles.
Elasticity composes: pass ``checkpoint=`` and a failed column (lost
shard, bad cell) costs exactly that column on the next submission of
the same spec (sweep.engine resume).

Under a data mesh, pass ``data_mesh=`` to ``submit``: it reaches the
sweep, whose runtimes activate the mesh on the job's own thread.  A
``use_data_mesh`` around ``submit`` does not reach the job — the active
mesh is per thread — so a threaded job would run unsharded.  Every rank
of the mesh submits the same jobs in the same order, so their
collectives meet.  ``runtime.distributed.inject_shard_failure`` arms one
budget per process: armed on any thread, it strikes the next reduction
of whichever job reaches one first.

Events are RuntimeEvents with action ``"column"`` (label = estimator
name, chunk_index = column index, detail = "" or the column error),
bracketed by ``"submitted"`` / ``"done"`` / ``"failed"`` markers.
With a tracer, each job runs under a ``job.sweep`` span and bumps
``jobs.*`` counters on the tracer's metrics registry.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer, maybe_span
from repro_torch.runtime.scheduler import EventLog, RuntimeEvent

PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"


def _on(dev: torch.device):
    """The job thread's current CUDA device set to ``dev`` (nothing on
    the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class SweepJob:
    """Handle for one submitted sweep: status, per-column events, and
    the result panel.  Thread-safe; created by ``JobManager.submit``."""

    def __init__(self, job_id: int, spec, n_columns: int,
                 events_maxlen: int = 512):
        self.job_id = job_id
        self.spec = spec
        self.n_columns = int(n_columns)
        self.events = EventLog(maxlen=events_maxlen)
        self._cond = threading.Condition()
        self._status = PENDING
        self._columns_done = 0
        self._columns_failed = 0
        self._panel = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- producer side (JobManager's worker thread) ---------------------
    def _emit(self, event: RuntimeEvent) -> None:
        with self._cond:
            self.events.append(event)
            self._cond.notify_all()

    def _on_column(self, index: int, col) -> None:
        err = getattr(col, "error", "") or ""
        with self._cond:
            self._columns_done += 1
            if err:
                self._columns_failed += 1
            self.events.append(
                RuntimeEvent("column", getattr(col, "estimator", ""),
                             index, "", str(err)))
            self._cond.notify_all()

    def _finish(self, panel=None, error: Optional[BaseException] = None):
        with self._cond:
            self._panel = panel
            self._error = error
            self._status = FAILED if error is not None else DONE
            self.events.append(
                RuntimeEvent(FAILED if error is not None else DONE,
                             f"job{self.job_id}", -1, "",
                             str(error) if error is not None else ""))
            self._cond.notify_all()

    # -- consumer side --------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "job_id": self.job_id,
                "status": self._status,
                "columns_done": self._columns_done,
                "columns_failed": self._columns_failed,
                "n_columns": self.n_columns,
                "events_total": self.events.total,
            }

    def done(self) -> bool:
        with self._cond:
            return self._status in (DONE, FAILED)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job settles (True) or ``timeout`` elapses
        (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._status not in (DONE, FAILED):
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def result(self, timeout: Optional[float] = None):
        """The EffectPanel (raises the job's error on FAILED)."""
        if not self.wait(timeout):
            raise TimeoutError(f"job {self.job_id} still {self._status}")
        if self._error is not None:
            raise self._error
        return self._panel

    def events_since(self, start_total: int):
        """Buffered events at/after the ``events.total`` checkpoint —
        the poll-style consumer (EventLog.since semantics)."""
        with self._cond:
            return self.events.since(start_total)

    def subscribe(self, *, poll_s: float = 0.05
                  ) -> Iterator[RuntimeEvent]:
        """Yield events in order as they land, ending when the job
        settles (the terminal done/failed event is yielded last)."""
        cursor = 0
        while True:
            with self._cond:
                batch = self.events.since(cursor)
                cursor = self.events.total
                settled = self._status in (DONE, FAILED)
                if not batch and not settled:
                    self._cond.wait(poll_s)
                    continue
            for ev in batch:
                yield ev
            if settled and cursor >= self.events.total:
                return


class JobManager:
    """Submit sweeps as background jobs; poll or subscribe for
    progress.  One manager per process is plenty — jobs are threads,
    each with its own runtimes and closures."""

    def __init__(self, *, tracer: Optional[Tracer] = None):
        self.tracer = tracer
        self._jobs: Dict[int, SweepJob] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()

    def submit(self, spec, *, X, y, t, segment_ids, z=None, seed: int = 0,
               device=None, block: bool = False, events_maxlen: int = 512,
               **sweep_kwargs) -> SweepJob:
        """Start ``sweep(spec, ...)`` as a job on ``device`` (None: the
        mesh's device, else the CUDA card).  ``sweep_kwargs`` pass
        through (executor, data_mesh, checkpoint, resume, mode, with_ci,
        ...); ``block=True`` runs inline — deterministic, for tests and
        scripted pipelines."""
        # lazy: the runtime must not import the sweep
        from repro_torch.sweep import sweep

        mesh = sweep_kwargs.get("data_mesh")
        dev = resolve_device(device if device is not None or mesh is None
                             else mesh.device)
        if dev.type == "cuda" and dev.index is None:
            # the submitting thread's card, fixed before the job's thread
            # starts with a current device of its own
            dev = torch.device("cuda", torch.cuda.current_device())

        with self._lock:
            job = SweepJob(next(self._ids), spec,
                           n_columns=len(spec.columns),
                           events_maxlen=events_maxlen)
            self._jobs[job.job_id] = job
        job._emit(RuntimeEvent("submitted", f"job{job.job_id}", -1, "",
                               f"columns={job.n_columns}"))
        tr = self.tracer
        if tr is not None:
            tr.metrics.counter("jobs.submitted").inc()

        def run():
            with self._lock:
                job._status = RUNNING
            try:
                with maybe_span(tr, "job.sweep", cat="jobs",
                                job_id=job.job_id,
                                n_columns=job.n_columns), _on(dev):
                    panel = sweep(spec, X=X, y=y, t=t,
                                  segment_ids=segment_ids, z=z, seed=seed,
                                  column_callback=job._on_column,
                                  device=dev, **sweep_kwargs)
            except BaseException as e:  # noqa: BLE001 — job boundary
                if tr is not None:
                    tr.metrics.counter("jobs.failed").inc()
                job._finish(error=e)
                return
            if tr is not None:
                tr.metrics.counter("jobs.done").inc()
                tr.metrics.counter("jobs.columns").inc(job.n_columns)
            job._finish(panel=panel)

        if block:
            run()
        else:
            th = threading.Thread(target=run,
                                  name=f"sweep-job-{job.job_id}",
                                  daemon=True)
            job._thread = th
            th.start()
        return job

    def get(self, job_id: int) -> SweepJob:
        with self._lock:
            return self._jobs[job_id]

    def status(self, job_id: int) -> Dict[str, Any]:
        return self.get(job_id).status()

    def jobs(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            handles = list(self._jobs.values())
        return {j.job_id: j.status() for j in handles}
