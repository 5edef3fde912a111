"""Per-device cost of a step, counted op by op at dispatch (the
counterpart of the reference's ``launch/hlo_cost.py``, which parses a
compiled XLA module; eager torch has no module to parse, so the ops are
counted as they run).

``count()`` is a ``TorchDispatchMode``; ``with count() as c:`` runs any
code and leaves its totals in ``c`` (``CostTotals``), always PER DEVICE:

  * under ``DTensor`` the mode steps aside for the tensor subclass
    (``NotImplemented``) and sees what each rank runs: the local ops on
    the local shards and the functional collectives (an (m, k) @ (k, n)
    matmul sharded 4 x 4 is counted at its local (m/4, k) @ (k, n/4)).
    The global-shape ops that DTensor's sharding propagation runs to
    learn output shapes are not counted.
  * flops: matmul-like ops by the formulas of ``torch.utils.
    flop_counter``'s registry (mm, bmm, addmm, convolutions, attention);
    pointwise ops and reductions count one per output element, as the
    reference counts its elementwise and reduce ops.
  * bytes: an op reads its operands and writes its output once each;
    views and metadata are free; a gather (index, gather, index_select,
    embedding) is charged twice its output (it reads what it writes) and
    a scatter or in-place slice write twice its update.
  * collectives (``_c10d_functional``, DTensor's shard-dim all-to-all):
    the payload's wire bytes by the ring factors of
    ``roofline.wire_bytes`` over the group named in the op, by op; their
    output counts as bytes too.
  * peak_bytes: the largest sum of live storages the counted ops
    allocated (each storage released when its last tensor dies), not
    counting what existed before the block: a storage at its full
    bytes, but a collective's at its output's own (a fake group's
    shard-dim all-to-all returns a view of ``group size`` copies of its
    input, where the card's collective writes the view alone);
    ``peak_top`` the largest storages live at that peak, each with the
    op that made it and its shape and dtype.
  * the port's kernels launch through ``ctypes``, out of dispatch's
    sight: each wrapper calls ``charge(kernel, flops, bytes)`` with its
    kernel's own cost formula, which adds to the totals and counts the
    launch in ``launches``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.roofline import wire_bytes

aten = torch.ops.aten


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0          # collective bytes on the links
    coll_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count: int = 0
    peak_bytes: int = 0
    peak_top: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def top(self, k: int = 10, key: int = 0) -> List[Any]:
        """The ``k`` ops with the most flops (key 0) or bytes (key 1):
        [(op, [flops, bytes, calls])]."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1][key])[:k]


def _packets(*ops) -> frozenset:
    return frozenset(getattr(aten, n) for n in ops if hasattr(aten, n))


_FREE = _packets(
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "arange", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "_local_scalar_dense", "is_same_size",
    "resize_", "set_", "record_stream")
_WRITE_ONLY = _packets(
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "scalar_tensor", "fill_", "zero_",
    "randn", "rand", "randn_like", "rand_like", "normal_", "uniform_")
_GATHERS = _packets("index", "gather", "index_select", "embedding")
# scatter-likes: (packet, index of the update operand)
_SCATTERS = {aten.index_put_: 2, aten.index_put: 2, aten.scatter_: 3,
             aten.scatter: 3, aten.scatter_add_: 3, aten.scatter_add: 3,
             aten.index_add_: 3, aten.index_add: 3, aten.index_copy_: 3,
             aten.index_copy: 3, aten.slice_scatter: 1,
             aten.select_scatter: 1, aten.copy_: 1}
_REDUCTIONS = _packets(
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "logsumexp", "_softmax", "_log_softmax", "cumsum", "cumprod",
    "norm", "linalg_vector_norm", "topk", "argmax", "argmin", "all", "any")

_COLLECTIVE = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all",
               "isend": "collective-permute"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements, but no more than its
    storage (an expanded operand reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _tensors(x) -> List[torch.Tensor]:
    return [a for a in tree_flatten(x)[0] if isinstance(a, torch.Tensor)]


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


PEAK_TOP = 5                      # storages listed at the peak

_ACTIVE: List["_CostMode"] = []
_PROPAGATING = [0]


def counting() -> bool:
    """Whether a ``count()`` is active."""
    return bool(_ACTIVE)


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Add one launch of ``kernel`` doing ``flops`` and moving ``nbytes``
    to every active ``count()``; nothing outside one."""
    for mode in _ACTIVE:
        t = mode.totals
        t.flops += flops
        t.bytes += nbytes
        t.launches[kernel] = t.launches.get(kernel, 0) + 1
        t.kernel_flops[kernel] = t.kernel_flops.get(kernel, 0.0) + flops
        t.kernel_bytes[kernel] = t.kernel_bytes.get(kernel, 0.0) + nbytes


class _CostMode(TorchDispatchMode):
    def __init__(self, totals: CostTotals):
        super().__init__()
        self.totals = totals
        # storage -> [bytes, refs, (op, shape, dtype) of its first tensor]
        self._live: Dict[int, List[Any]] = {}
        self._live_bytes = 0

    # -- peak bytes ---------------------------------------------------------
    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self._live_bytes -= ent[0]
            del self._live[key]

    def _track(self, func, out) -> None:
        peaked = False
        own = func.namespace in ("_c10d_functional", "_dtensor")
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
                key, nb = st._cdata, _nbytes(t) if own else st.nbytes()
            except (RuntimeError, NotImplementedError):
                continue
            ent = self._live.get(key)
            if ent is None:
                self._live[key] = ent = [nb, 0, (
                    func.overloadpacket.__name__, tuple(t.shape),
                    str(t.dtype).replace("torch.", ""))]
                self._live_bytes += nb
                if self._live_bytes > self.totals.peak_bytes:
                    self.totals.peak_bytes = self._live_bytes
                    peaked = True
            ent[1] += 1
            weakref.finalize(t, self._release, key)
        if peaked:
            self.totals.peak_top = [
                {"op": op, "shape": list(shape), "dtype": dt, "bytes": nb}
                for nb, _, (op, shape, dt) in heapq.nlargest(
                    PEAK_TOP, self._live.values(), key=lambda e: e[0])]

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out
        self._count(func, args, kwargs, out)
        if not func.is_view:
            self._track(func, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self.totals
        f0, b0 = t.flops, t.bytes
        self._count_op(func, args, kwargs, out)
        ent = t.by_op.setdefault(func.overloadpacket.__name__, [0.0, 0.0, 0])
        ent[0] += t.flops - f0
        ent[1] += t.bytes - b0
        ent[2] += 1

    def _count_op(self, func, args, kwargs, out) -> None:
        t = self.totals
        packet = func.overloadpacket
        ns = func.namespace
        if ns in ("_c10d_functional", "_dtensor"):
            kind = _COLLECTIVE.get(packet.__name__)
            if kind is None:
                return                                  # wait_tensor
            group = args[-1]
            if kind in ("all-gather", "reduce-scatter"):
                payload = sum(_nbytes(o) for o in _tensors(out))
            else:
                payload = _nbytes(args[0])
            wire = wire_bytes(kind, payload, _group_size(group))
            t.wire_bytes += wire
            t.coll_by_op[kind] = t.coll_by_op.get(kind, 0.0) + wire
            t.coll_count += 1
            t.bytes += sum(_nbytes(o) for o in _tensors(out))
            return
        if ns == "prim" or func.is_view or packet in _FREE:
            return
        outs = _tensors(out)
        if packet in _WRITE_ONLY:
            t.bytes += sum(_nbytes(o) for o in outs)
        elif packet in _GATHERS:
            t.bytes += 2 * sum(_nbytes(o) for o in outs)
        elif packet in _SCATTERS:
            upd = _tensors(list(args)[_SCATTERS[packet]:
                                      _SCATTERS[packet] + 1])
            t.bytes += 2 * sum(_nbytes(u) for u in upd)
        else:
            t.bytes += sum(_nbytes(a) for a in _tensors((args, kwargs)))
            t.bytes += sum(_nbytes(o) for o in outs)
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            t.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags or packet in _REDUCTIONS:
            t.flops += sum(o.numel() for o in outs)


@contextlib.contextmanager
def _skip_sharding_propagation():
    """Leave out the ops DTensor's sharding propagation runs on global
    shapes to learn an output's metadata: they are not executed work."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        yield
        return
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **k):
        _PROPAGATING[0] += 1
        try:
            return orig(self, *a, **k)
        finally:
            _PROPAGATING[0] -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def count(totals: Optional[CostTotals] = None):
    """Count every op (and every ``charge``) inside the block into a
    ``CostTotals``, per device."""
    totals = totals if totals is not None else CostTotals()
    mode = _CostMode(totals)
    _ACTIVE.append(mode)
    try:
        with _skip_sharding_propagation(), mode:
            yield totals
    finally:
        _ACTIVE.remove(mode)
