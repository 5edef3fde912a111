"""repro_torch.runtime — the Ray-style task-graph runtime and the data mesh.

The scheduling layer the paper attributes to Ray, over the port's
executors (``serial | vmap | shard_map``): ``TaskFuture`` handles and deterministic
DAG execution give Ray's ``ObjectRef`` semantics (``future``), an affine
peak-memory model fitted from two probed chunks sizes replicate chunks
against ``runtime_memory_budget`` (``memory``), and ``TaskRuntime``
(``scheduler``) streams the chunks with per-chunk retry down the backend
ladder — results stay bitwise the no-failure run's, because every
replicate function of the port is batch-invariant.  Bootstrap,
jackknife, crossfit, refutation and the sweep's cells all dispatch
through it; ``jobs`` runs sweeps as background jobs.  The paper's
data parallelism is ``distributed``: rows split over the ranks of a
``torch.distributed`` group, each rank reduces its row blocks to
Gram-shaped partials and only those cross the group — bitwise the
single-process chunked fold in the "ordered" mode — and
``TaskRuntime(data_mesh=...)`` runs its chunks on the mesh first, with a
lost shard dropping the chunk to the single-host ladder.  The sweep's
cells (``sweep(data_mesh=)``, a shard_map column splitting its cells over
the ranks), the store's ingests (``MomentStore(data_mesh=)``) and jobs
(``JobManager.submit(data_mesh=)``) run under a mesh; checkpoints under
a mesh are written by rank 0 (``first_rank_writes``).
"""
#   future.py     TaskFuture handles + deterministic DAG execution
#                 (submit/call/gather — Ray's ObjectRef semantics)
#   memory.py     affine peak-memory model from probed chunks (the CUDA
#                 allocator's peak) -> auto chunk sizing; chunk costs
#                 from the seg_gram launches
#   scheduler.py  TaskRuntime: memory-aware chunked maps, per-chunk
#                 retry with backend downgrade (data mesh -> shard_map
#                 -> vmap -> serial, bitwise results), nested (outer x
#                 inner) parallelism via map_product
#   distributed.py row-sharded moment reduction over a torch.distributed
#                 group — ordered mode bitwise the single-process chunked
#                 fold, psum mode one all-reduce
#   jobs.py       minimal job-submission + event-stream API over
#                 sweeps: submit a SweepSpec, poll status, subscribe
#                 to per-column completion events (EventLog-backed)
from repro_torch.runtime.distributed import (
    DataMesh,
    ShardLostError,
    agree_min,
    current_data_mesh,
    dist_reduce,
    first_rank_writes,
    inject_shard_failure,
    make_data_mesh,
    use_data_mesh,
)
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
    "DataMesh",
    "ShardLostError",
    "agree_min",
    "current_data_mesh",
    "dist_reduce",
    "first_rank_writes",
    "inject_shard_failure",
    "make_data_mesh",
    "use_data_mesh",
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
