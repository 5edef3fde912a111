"""repro_torch.runtime — the Ray-style task-graph runtime on one card.

The scheduling layer the paper attributes to Ray, over the port's
executors (``serial | vmap``): ``TaskFuture`` handles and deterministic
DAG execution give Ray's ``ObjectRef`` semantics (``future``), an affine
peak-memory model fitted from two probed chunks sizes replicate chunks
against ``runtime_memory_budget`` (``memory``), and ``TaskRuntime``
(``scheduler``) streams the chunks with per-chunk retry down the backend
ladder — results stay bitwise the no-failure run's, because every
replicate function of the port is batch-invariant.  Bootstrap,
jackknife, crossfit, refutation and the sweep's cells all dispatch
through it; ``jobs`` runs sweeps as background jobs.

The reference's ``runtime.distributed`` (the row-sharded data mesh:
``DataMesh``, ``make_data_mesh``, ``use_data_mesh``, ``dist_reduce``,
``ShardLostError``, ...) lands with the multi-card slice, ROADMAP A.10.
"""
#   future.py     TaskFuture handles + deterministic DAG execution
#                 (submit/call/gather — Ray's ObjectRef semantics)
#   memory.py     affine peak-memory model from probed chunks (the CUDA
#                 allocator's peak) -> auto chunk sizing; chunk costs
#                 from the seg_gram launches
#   scheduler.py  TaskRuntime: memory-aware chunked maps, per-chunk
#                 retry with backend downgrade (vmap -> serial, bitwise
#                 results), nested (outer x inner) parallelism via
#                 map_product
#   jobs.py       minimal job-submission + event-stream API over
#                 sweeps: submit a SweepSpec, poll status, subscribe
#                 to per-column completion events (EventLog-backed)
from repro_torch.runtime.future import TaskFuture, TaskGraph, resolve
from repro_torch.runtime.memory import (
    ChunkCost,
    MemoryModel,
    memory_model,
    probe_chunk_cost,
    probe_peak_bytes,
)
from repro_torch.runtime.scheduler import (
    DOWNGRADE,
    EventLog,
    RuntimeEvent,
    TaskRuntime,
    as_runtime,
)

from repro_torch.runtime.jobs import JobManager, SweepJob

__all__ = [
    "JobManager",
    "SweepJob",
    "TaskFuture",
    "TaskGraph",
    "resolve",
    "ChunkCost",
    "MemoryModel",
    "memory_model",
    "probe_chunk_cost",
    "probe_peak_bytes",
    "DOWNGRADE",
    "EventLog",
    "RuntimeEvent",
    "TaskRuntime",
    "as_runtime",
]
