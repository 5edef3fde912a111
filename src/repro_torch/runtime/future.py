"""Lightweight task handles + DAG bookkeeping for the runtime.

Ray's core abstraction is the *future*: ``f.remote(...)`` returns an
ObjectRef immediately, dependencies between refs form a task graph, and
``ray.get`` drives the graph.  The port keeps the shape of
that API — ``TaskRuntime.submit(...)`` returns a :class:`TaskFuture`,
futures may appear as inputs to later submissions (their results are
spliced in at execution time), and ``TaskRuntime.gather`` executes the
induced DAG in deterministic topological order — but the "cluster" under
it is the executor layer on one card (serial | vmap), so a *map* task's
replicate axis becomes batched kernel launches instead of B scheduled
workers.

Two task kinds:

  map    ``fn`` is mapped over the leading replicate axis of ``xs``
         through the scheduler (chunked, fault-tolerant) — the Ray task
         *pool* (one submit = B logical tasks);
  call   ``fn(*args)`` runs once on the host — the glue nodes of a
         graph (survivor selection between tuning rungs, reductions),
         Ray's plain ``@ray.remote`` function.

The graph is static once gathered: execution order is the deterministic
topological order of submission indices, so repeated gathers of the
same graph replay identically (the lineage property replicate keys
already give at the numerics level).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Sequence, Tuple

_UNSET = object()


@dataclasses.dataclass
class TaskFuture:
    """Handle for a submitted task.  Cheap, hashable by identity; holds
    its result after the owning runtime executed it."""

    task_id: int
    kind: str  # "map" | "call"
    fn: Callable[..., Any]
    xs: Any  # map tasks: pytree with replicate axis
    args: Tuple[Any, ...]
    deps: Tuple["TaskFuture", ...]
    label: str = ""
    _result: Any = _UNSET

    @property
    def done(self) -> bool:
        return self._result is not _UNSET

    def result(self) -> Any:
        if not self.done:
            raise RuntimeError(
                f"task {self.task_id} ({self.label or self.fn!r}) has not "
                "been executed — gather() it through its runtime first"
            )
        return self._result

    def _set(self, value: Any) -> None:
        self._result = value

    def __hash__(self) -> int:  # identity hash: ids are unique
        return self.task_id

    def __eq__(self, other: Any) -> bool:
        return self is other


def _iter_futures(obj: Any):
    """Yield TaskFutures reachable from ``obj`` (one level of list/tuple/
    dict nesting — the containers submissions actually use)."""
    if isinstance(obj, TaskFuture):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _iter_futures(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _iter_futures(o)


def resolve(obj: Any) -> Any:
    """Replace every (completed) TaskFuture in ``obj`` by its result."""
    if isinstance(obj, TaskFuture):
        return obj.result()
    if isinstance(obj, (list, tuple)):
        return type(obj)(resolve(o) for o in obj)
    if isinstance(obj, dict):
        return {k: resolve(v) for k, v in obj.items()}
    return obj


class TaskGraph:
    """Submission log + topological executor.  Owned by a TaskRuntime;
    the runtime supplies the map-task execution primitive."""

    def __init__(self) -> None:
        self._counter = itertools.count()

    def submit(
        self,
        kind: str,
        fn: Callable[..., Any],
        xs: Any,
        args: Sequence[Any],
        deps: Sequence[TaskFuture] = (),
        label: str = "",
    ) -> TaskFuture:
        implicit = tuple(_iter_futures(xs)) + tuple(
            f for a in args for f in _iter_futures(a)
        )
        return TaskFuture(
            task_id=next(self._counter),
            kind=kind,
            fn=fn,
            xs=xs,
            args=tuple(args),
            deps=tuple(dict.fromkeys(implicit + tuple(deps))),
            label=label,
        )

    @staticmethod
    def order(targets: Sequence[TaskFuture]) -> Tuple[TaskFuture, ...]:
        """Deterministic topological order of every task ``targets``
        depend on (ties broken by submission id)."""
        seen: dict = {}
        out = []

        def visit(f: TaskFuture, stack: Tuple[int, ...]) -> None:
            if f.task_id in stack:
                raise ValueError(f"task graph has a cycle through task {f.task_id}")
            if f.task_id in seen:
                return
            for d in sorted(f.deps, key=lambda d: d.task_id):
                visit(d, stack + (f.task_id,))
            seen[f.task_id] = f
            out.append(f)

        for t in sorted(targets, key=lambda f: f.task_id):
            visit(t, ())
        return tuple(out)

    def execute(
        self,
        targets: Sequence[TaskFuture],
        run_map: Callable[[TaskFuture], Any],
        run_call: Optional[Callable[[TaskFuture], Any]] = None,
    ) -> None:
        """Run every not-yet-done task ``targets`` depend on, in
        deterministic topological order.  ``run_map`` executes a map
        task (the runtime's chunked scheduler); call tasks run through
        ``run_call`` (the runtime's span around it), inline without."""
        for fut in self.order(targets):
            if fut.done:
                continue
            if fut.kind == "map":
                fut._set(run_map(fut))
            elif run_call is not None:
                fut._set(run_call(fut))
            else:
                fut._set(fut.fn(*resolve(fut.args)))
