"""Logical-axis sharding: the one place that decides how tensors map onto
a device mesh (the reference's ``distributed/sharding.py``).

Modules declare parameters as ``ParamDef`` schemas with *logical* axis
names ("embed", "heads", "ff", "experts", ...).  ``ShardingRules``
translate logical names to mesh axes, and ``logical_to_spec`` turns a
leaf's axes into a ``PartitionSpec``: the same schema serves the
one-device smoke tests and the 512-rank dry run unchanged.

A spec becomes torch placements through ``NamedSharding``: a mesh dim
that a tensor dim names is ``Shard(d)``, a tuple entry such as ("pod",
"data") shards one tensor dim over several mesh dims in mesh order, and
every other mesh dim is ``Replicate()``.  ``distribute`` places a tensor
that every rank holds whole (no collective).  ``constrain`` is the
reference's activation sharding constraint: inside ``mesh_context`` it
redistributes a ``DTensor`` to the spec of its logical axes, and
anywhere else — no rules, no active mesh, a plain tensor — it returns
its argument itself, so the model code runs unchanged outside a mesh.

Where DTensor has no sharding rule for an op the model runs (or one
that gathers a whole tensor), the model reaches it through a helper
that does plain torch on a plain tensor and, on a DTensor, computes
each rank's part on its local shard: ``rowwise`` (the MoE's row-local
dispatch and combine), ``take_rows`` (a vocabulary-parallel embedding
lookup), ``take_last`` (the CE's label gather, its backward on the
shard), ``logsumexp_last`` (a sharded vocab's logsumexp), ``write_slot``
(a decode step's cache write on the shard that holds the slot), ``like``
(an in-place write's source in its destination's layout), ``whole_dim``
(a scanned dim gathered once before a chunk loop), ``pad`` (the token
shift's and the causal conv's zero padding of the time dim), ``row_sum``
(a moments pass over row-sharded data: each rank's rows, then an
all-reduce of the partial sums), ``per_shard`` (row-local work on
each rank's shards), ``cumsum`` (the scans' cumulative logs),
``rows_like``, and the products ``einsum`` / ``matmul`` / ``bmm`` (on
DTensors one local product on each rank's shards, ``sharded_einsum``),
which every product of the model code calls.  Nothing of torch is
swapped: a step on DTensors opens ``dtensor_ops`` (implicit
replication) and nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + initializer.  The
    axes ("embed", "heads", "ff", ...) are what ``logical_to_spec``
    maps onto a mesh; every schema leaf names one per dimension."""

    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"  # normal | zeros | ones | scaled | embed
    scale: Optional[float] = None
    dtype: Any = None  # filled from ModelConfig.param_dtype if None


def map_schema(fn, schema, path: str = ""):
    """``fn(path, ParamDef)`` over every leaf, paths dotted."""
    if isinstance(schema, ParamDef):
        return fn(path, schema)
    if isinstance(schema, Mapping):
        return {k: map_schema(fn, v, f"{path}.{k}" if path else k)
                for k, v in schema.items()}
    raise TypeError(f"bad schema node at {path!r}: {type(schema)}")


def init_std(d: ParamDef) -> float:
    """The reference's std for a "normal" / "scaled" / "embed" leaf."""
    fan_in = d.shape[0] if len(d.shape) else 1
    if d.init == "scaled":
        return (d.scale if d.scale is not None else 1.0) / max(1.0, fan_in) ** 0.5
    return d.scale if d.scale is not None else 0.02


def init_params(gen: torch.Generator, schema,
                param_dtype=torch.float32) -> Dict[str, Any]:
    """Materialise a schema into a nested dict of tensors, drawn in
    schema order on ``gen`` (and on its device)."""
    dev = gen.device

    def make(_, d: ParamDef):
        dtype = d.dtype or param_dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(init_std(d)).to(dtype)

    return map_schema(make, schema)


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of them, or None.  A
    plain tuple, so it compares equal to ``tuple(P(...))`` of JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    rules: Tuple[Tuple[str, Any], ...]

    def get(self, name: Optional[str]):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None


def default_rules(*, fsdp: bool = True, sequence_parallel: bool = False,
                  multi_pod: bool = False, shard_kv_seq: bool = False,
                  fold_axis: Optional[str] = None) -> ShardingRules:
    """Production rules for the (pod, data, model) mesh.

    - batch over ("pod","data") — DP across pods and the data axis.
    - TP dims (heads/ff/vocab/experts) over "model".
    - fsdp shards the 'embed' dim of weights over "data" (+"pod") — ZeRO-3.
    """
    dp: Any = ("pod", "data") if multi_pod else "data"
    weight_dp = dp if fsdp else None
    r = [
        ("batch", dp),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ff", "model"),
        ("experts", dp),
        ("expert_embed", None),
        ("expert_ff", "model"),
        ("embed", weight_dp),
        ("embed_act", None),   # activations' d_model dim stays unsharded
        ("seq", "model" if sequence_parallel else None),
        ("attn_seq", None),    # q's seq dim inside attention (cells.py may
                               # map it to "model" when heads don't divide TP)
        ("logits_seq", None),  # logits' seq dim (vocab claims "model")
        ("kv_seq", dp if shard_kv_seq else None),
        ("head_dim", None),
        ("state", None),
        ("layers", None),
        ("fold", fold_axis),
        ("qk_lora", None),
        ("inner", "model"),    # mamba/rwkv expanded inner dim
        ("rows", dp),          # causal-data rows (DML engine)
        ("row_block", None),   # the block index of blocked moments
                               # partials — never sharded
        ("replicate", dp),     # bootstrap/tuning replicate axis
    ]
    return ShardingRules(rules=tuple(r))


def _axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError(f"{mesh!r} has no axis names")
    return tuple(names)


def logical_to_spec(axes: Sequence[Optional[str]], rules: ShardingRules,
                    mesh=None) -> PartitionSpec:
    """Translate logical axes to a PartitionSpec, dropping mesh axes that
    do not exist on ``mesh`` (lets one rule set serve all mesh shapes).
    A mesh axis may appear only once in a spec; later logical axes that
    map to an already-used mesh axis fall back to replicated (e.g. under
    sequence parallelism 'seq' claims "model" before 'vocab' would)."""
    names = set(_axis_names(mesh)) if mesh is not None else None
    used = set()

    def ok(ax):
        return (names is None or ax in names) and ax not in used

    out = []
    for a in axes:
        m = rules.get(a)
        if m is None:
            out.append(None)
        elif isinstance(m, (tuple, list)):
            kept = tuple(x for x in m if ok(x))
            used.update(kept)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            if ok(m):
                used.add(m)
                out.append(m)
            else:
                out.append(None)
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``torch.distributed.device_mesh.DeviceMesh``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        """One placement per mesh dim: ``Shard(d)`` where tensor dim d
        names the mesh dim, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = _axis_names(self.mesh)
        out: List[Any] = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax not in names:
                    raise ValueError(f"spec {self.spec} names mesh axis "
                                     f"{ax!r}, not one of {names}")
                out[names.index(ax)] = Shard(d)
        return tuple(out)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a ``DTensor`` under ``sharding``.  Every rank holds the
    whole ``t`` (``src_data_rank=None``), so nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Over schemas
# ---------------------------------------------------------------------------

def _axes(path: str, d: ParamDef) -> Tuple[Optional[str], ...]:
    if d.axes is None or len(d.axes) != len(d.shape):
        raise ValueError(f"{path}: ParamDef axes {d.axes} do not name each "
                         f"dim of shape {d.shape}")
    return tuple(d.axes)


def param_specs(schema, rules: ShardingRules, mesh=None):
    """Nested dict of PartitionSpecs mirroring the schema."""
    return map_schema(lambda p, d: logical_to_spec(_axes(p, d), rules, mesh),
                      schema)


def param_shardings(schema, rules: ShardingRules, mesh):
    """Nested dict of NamedShardings mirroring the schema."""
    return map_schema(lambda p, d: NamedSharding(
        mesh, logical_to_spec(_axes(p, d), rules, mesh)), schema)


def abstract_params(schema, param_dtype=torch.float32):
    """The schema's tensors on the meta device (no allocation)."""
    return map_schema(lambda _, d: torch.empty(
        d.shape, dtype=d.dtype or param_dtype, device="meta"), schema)


def tree_size_bytes(tree) -> int:
    """Bytes of every tensor leaf of nested dicts / lists (a DTensor
    counts at its global size)."""
    if isinstance(tree, torch.Tensor):
        return int(tree.numel() * tree.element_size())
    if isinstance(tree, Mapping):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    return 0


# ---------------------------------------------------------------------------
# The active mesh and activation constraints
# ---------------------------------------------------------------------------

_MESHES: List[Any] = []


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh that ``constrain`` reads."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def active_mesh():
    """The innermost ``mesh_context``'s mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: Optional[ShardingRules]) -> torch.Tensor:
    """Redistribute ``x`` to the spec of its logical ``axes``; ``x``
    itself when ``rules`` is None, outside a ``mesh_context`` or when
    ``x`` is not a ``DTensor``."""
    if rules is None:
        return x
    mesh = active_mesh()
    if mesh is None:
        return x
    return constrain_to(x, logical_to_spec(tuple(axes)[:x.dim()], rules,
                                           mesh))


def constrain_to(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """Redistribute ``x`` to ``spec`` on the active mesh; ``x`` itself
    outside a ``mesh_context`` or when ``x`` is not a ``DTensor``."""
    mesh = active_mesh()
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    names = set(_axis_names(mesh))

    def keep(e):
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return e if e in names else None

    spec = P(*[keep(e) for e in spec])
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` whole on each rank (a ``DTensor`` sharded
    there gathered once, as XLA gathers a scanned dim before a scan);
    ``x`` itself otherwise.  A loop that indexes a sharded dim step by
    step would gather the whole tensor at every step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, pads)`` with zeros; on a ``DTensor`` each rank pads its
    local shard, every padded dim gathered whole first (``whole_dim``),
    and the result keeps ``x``'s placements.  The token shift and the
    causal conv pad the time dim this way: DTensor's own ``F.pad`` rule
    differs across torch versions (2.11 fails it)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return F.pad(x, tuple(pads))
    grow = [0] * x.dim()
    for i in range(0, len(pads), 2):
        grow[x.dim() - 1 - i // 2] = pads[i] + pads[i + 1]
    for d, g in enumerate(grow):
        if g:
            x = whole_dim(x, d)
    loc = F.pad(x.to_local(), tuple(pads))
    shape = torch.Size(n + g for n, g in zip(x.shape, grow))
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def like(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` laid out as ``dst`` for an in-place write into ``dst``
    (or a view of it): redistributed when both are ``DTensor``s with
    other placements, else ``src`` itself."""
    from torch.distributed.tensor import DTensor
    if (isinstance(src, DTensor) and isinstance(dst, DTensor)
            and tuple(src.placements) != tuple(dst.placements)):
        return src.redistribute(dst.device_mesh, dst.placements)
    return src


def local_shape_and_offset(shape, mesh, placements):
    """(this rank's shard shape, its offset in the global tensor) of a
    tensor of ``shape`` under ``placements`` on ``mesh``: each Shard(d)
    splits dim d as ``torch.chunk`` does, mesh dims in order."""
    from torch.distributed.tensor import Shard
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, o = Shard.local_shard_size_and_offset(
                size[p.dim], mesh.size(m), coord[m])
            size[p.dim], off[p.dim] = n, off[p.dim] + o
    return tuple(size), tuple(off)


class _TakeLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` of a DTensor ``x`` whose backward
    stays on each rank's shard: the gradient is scattered into zeros of
    the local shard at the indices that fall in it.  (torch's own gather
    backward starts from ``new_zeros`` of the global shape, a replicated
    buffer the size of the whole logits on every rank.)"""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (x.device_mesh, tuple(x.placements), x.shape, x.stride())
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        (idx,) = ctx.saved_tensors
        mesh, pl, shape, stride = ctx.meta
        last = len(shape) - 1
        rows = [Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in pl]
        g_loc = g.redistribute(mesh, rows).to_local()
        i_loc = idx.redistribute(mesh, rows).to_local()
        lshape, off = local_shape_and_offset(shape, mesh, pl)
        i_loc = i_loc - off[last]
        inside = (i_loc >= 0) & (i_loc < lshape[last])
        grad = torch.zeros(lshape, dtype=g_loc.dtype, device=g_loc.device)
        grad.scatter_add_(-1, i_loc.clamp(0, max(lshape[last] - 1, 0)),
                          g_loc * inside)
        return DTensor.from_local(grad, mesh, pl, run_check=False,
                                  shape=shape, stride=stride), None


class _TakeRows(torch.autograd.Function):
    """``table[ids]`` of a DTensor table (V, d): a vocabulary-parallel
    lookup.  Each rank keeps the table's vocab shards (its other dims
    gathered; a mesh dim that shards the ids' rows too gives its vocab
    shard up), looks up the ids that fall in its rows, zeros the rest,
    and returns a partial sum over the vocab's mesh dims; the backward
    adds the gradient rows into zeros of the local vocab shard, a
    partial sum over the ids' row dims, by the op the backward of a
    plain ``table[ids]`` takes (``index_put_`` with accumulate: sorted,
    deterministic on the card, where ``index_add_``'s atomics add a
    bf16 gradient in no fixed order).  DTensor's own index rules have
    no strategy for ids sharded over two mesh dims ("hybrid" sharding)."""

    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = table.device_mesh
        ipl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in ids.placements]
        tpl = [Shard(0) if isinstance(p, Shard) and p.dim == 0
               and not isinstance(ipl[m], Shard) else Replicate()
               for m, p in enumerate(table.placements)]
        t_loc = table.redistribute(mesh, tpl).to_local()
        (rows, _), (off, _) = local_shape_and_offset(table.shape, mesh, tpl)
        i_loc = ids.redistribute(mesh, ipl).to_local() - off
        inside = (i_loc >= 0) & (i_loc < rows)
        i_loc = i_loc.clamp(0, max(rows - 1, 0))
        out = t_loc[i_loc] * inside[..., None].to(t_loc.dtype)
        opl = [ipl[m] if isinstance(ipl[m], Shard) else
               (Partial() if isinstance(tpl[m], Shard) else Replicate())
               for m in range(mesh.ndim)]
        ctx.save_for_backward(i_loc, inside)
        ctx.meta = (mesh, ipl, tpl, table.shape, table.stride(), rows)
        shape = tuple(ids.shape) + (table.shape[1],)
        return DTensor.from_local(out, mesh, opl, run_check=False,
                                  shape=shape, stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        i_loc, inside = ctx.saved_tensors
        mesh, ipl, tpl, shape, stride, rows = ctx.meta
        g_loc = g.redistribute(mesh, ipl).to_local()
        d = g_loc.shape[-1]
        grad = torch.zeros((rows, d), dtype=g_loc.dtype, device=g_loc.device)
        grad.index_put_((i_loc.reshape(-1),),
                         (g_loc * inside[..., None].to(g_loc.dtype))
                         .reshape(-1, d), accumulate=True)
        gpl = [tpl[m] if isinstance(tpl[m], Shard) else
               (Partial() if isinstance(ipl[m], Shard) else Replicate())
               for m in range(mesh.ndim)]
        return DTensor.from_local(grad, mesh, gpl, run_check=False,
                                  shape=shape, stride=stride), None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup); on a ``DTensor`` table the
    vocabulary-parallel ``_TakeRows``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(table, DTensor):
        return table[ids]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    return _TakeRows.apply(table, ids)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx)``; on a ``DTensor`` with a backward that
    keeps the gradient sharded as ``x`` (``_TakeLast``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and x.requires_grad:
        if not isinstance(idx, DTensor):
            from torch.distributed.tensor import Replicate
            idx = DTensor.from_local(idx, x.device_mesh,
                                     [Replicate()] * x.device_mesh.ndim,
                                     run_check=False)
        return _TakeLast.apply(x, idx)
    return torch.gather(x, -1, idx)


def rowwise(fn: Callable[..., Any], *args, dims: Sequence[int] = (0,)):
    """``fn(*args)`` where ``fn`` works on rows independently (dim 0 of
    every tensor argument and output): on ``DTensor``s each rank runs it
    on its own rows — dim 0 sharded as the first DTensor argument shards
    it, every other dim whole — and the outputs come back as DTensors
    laid out so.  The reference's row-local MoE dispatch (``vmap`` over
    the batch) is how it shards there; DTensor has no rule for its
    sort / scatter / gather ops.  ``dims`` names more independent dims
    kept sharded the same way (attention: batch and heads, ``(0, 2)``);
    an output's dim d in ``dims`` has the first DTensor argument's size
    there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
          for p in ref.placements]
    out = fn(*[a.redistribute(mesh, pl).to_local()
               if isinstance(a, DTensor) else a for a in args])

    def wrap(o):
        shape = tuple(ref.shape[d] if d in dims else n
                      for d, n in enumerate(o.shape))
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole_sums(x):
    """A ``DTensor`` with its partial sums reduced (``Partial`` mesh dims
    made ``Replicate``); anything else itself."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _local(x):
    """This rank's shard of a ``DTensor`` (its partial sums reduced
    first); anything else itself."""
    from torch.distributed.tensor import DTensor
    return whole_sums(x).to_local() if isinstance(x, DTensor) else x


def row_sum(fn: Callable[..., Any], *args):
    """``fn(*args)`` where ``fn`` is a moments pass: every output a sum
    of per-row terms over the rows its row-indexed arguments share.  On
    ``DTensor``s whose rows are sharded each rank runs ``fn`` on its own
    local shards — its rows only, through the kernels on a card — and
    the partial sums are added over the mesh dims that shard the rows
    (an all-reduce an output).  The outputs are plain tensors, whole and
    equal on every rank, as a one-device pass returns them.  Arguments
    that are not row-indexed (a coefficient vector) are plain or
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    out = fn(*[_local(a) for a in args])
    pl = [Partial() if any(isinstance(a.placements[m], Shard) for a in dts)
          else Replicate() for m in range(mesh.ndim)]

    def total(o):
        return DTensor.from_local(o, mesh, pl, run_check=False).full_tensor()

    return tuple(total(o) for o in out) if isinstance(out, tuple) \
        else total(out)


def per_shard(fn: Callable[..., Any], *args, out_dim: Optional[int] = None):
    """``fn(*args)`` where ``fn`` is row-local work over broadcasting
    operands (comparisons, gathers along a non-row dim, products with a
    small replicated operand): on ``DTensor``s each rank applies ``fn``
    to its local shards, and the output keeps the first DTensor
    argument's shards: its Shard(d) becomes the output's Shard(out_dim),
    or, with ``out_dim`` None, Shard(d + out.ndim - arg.ndim) (dims
    aligned from the right, as broadcasting aligns them).  DTensor's own
    rules for such ops differ across torch versions (2.11 has none for
    ``ne``); the work on each rank is the plain op's on its rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    out = fn(*[_local(a) for a in args])

    def wrap(o):
        def at(d):
            return d + o.dim() - ref.dim() if out_dim is None else out_dim

        pl = [Shard(at(p.dim)) if isinstance(p, Shard) else Replicate()
              for p in ref.placements]
        shape = list(o.shape)
        for p in ref.placements:
            if isinstance(p, Shard):
                shape[at(p.dim)] = ref.shape[p.dim]
        return DTensor.from_local(o, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


class _LocalCumsum(torch.autograd.Function):
    """``torch.cumsum`` of a DTensor along a dim no mesh dim splits, on
    each rank's shard, forward and backward (the backward is the reverse
    cumsum: flip, cumsum, flip)."""

    @staticmethod
    def forward(ctx, x, dim):
        from torch.distributed.tensor import DTensor
        ctx.meta = (x.device_mesh, tuple(x.placements), dim)
        return DTensor.from_local(torch.cumsum(x.to_local(), dim),
                                  x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        mesh, pl, dim = ctx.meta
        g_loc = g.redistribute(mesh, pl).to_local()
        out = torch.flip(torch.cumsum(torch.flip(g_loc, (dim,)), dim),
                         (dim,))
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=g.shape, stride=g.stride()), None


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``; on a ``DTensor`` on each rank's shard
    (``dim`` gathered whole first when a mesh dim splits it), its
    backward too (``_LocalCumsum``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    dim = dim % x.dim()
    return _LocalCumsum.apply(whole_sums(whole_dim(x, dim)), dim)


def rows_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor every rank holds whole whose dim 0 indexes the
    same rows as ``ref``'s, laid out as ``ref``: on a ``DTensor`` ``ref``
    distributed under its placements (each rank keeps its own rows; no
    collective), else ``x`` itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(ref, DTensor) or isinstance(x, DTensor):
        return x
    return distribute_tensor(x, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1, keepdim=True)``; on a ``DTensor`` whose
    last dim no mesh dim of more than one rank splits, the same op on
    each rank's shard (a split over one rank is the whole dim); else
    max + log Σ exp(x - max) over the local shard of the last dim with
    the max and the sum reduced across its shards (torch's logsumexp
    rule gathers a sharded last dim whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1, keepdim=True)
    mesh, last = x.device_mesh, x.dim() - 1

    def splits_last(m, p):
        return isinstance(p, Shard) and p.dim == last and mesh.size(m) > 1

    if not any(splits_last(m, p) for m, p in enumerate(x.placements)):
        x = whole_sums(x)
        pl = [Replicate() if isinstance(p, Shard) and p.dim == last else p
              for p in x.placements]
        shape = torch.Size(tuple(x.shape[:-1]) + (1,))
        return DTensor.from_local(
            torch.logsumexp(_local(x), dim=-1, keepdim=True), mesh, pl,
            run_check=False, shape=shape, stride=_contiguous_stride(shape))
    m = x.detach().amax(dim=-1, keepdim=True)
    return m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))


def write_slot(cache: torch.Tensor, at: int, new: torch.Tensor) -> None:
    """``cache[:, at] = new`` in place (a decode step's cache write, the
    reference's ``dynamic_update_slice`` at ``at`` on dim 1).  On a
    ``DTensor`` cache each rank writes its own shard: ``new`` is laid out
    as the slot (``cache``'s placements with dim 1 dropped), and a rank
    whose shard of dim 1 holds ``at`` writes it locally."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(cache, DTensor):
        cache[:, at] = new
        return
    mesh, pl = cache.device_mesh, cache.placements
    slot_pl = [p if not isinstance(p, Shard) or p.dim == 0
               else (Shard(p.dim - 1) if p.dim > 1 else None) for p in pl]
    from torch.distributed.tensor import Replicate
    slot_pl = [Replicate() if p is None else p for p in slot_pl]
    if not isinstance(new, DTensor):
        raise TypeError("a DTensor cache takes a DTensor slot")
    local_new = new.redistribute(mesh, slot_pl).to_local()
    shape, offset = local_shape_and_offset(cache.shape, mesh, pl)
    i = at - offset[1]
    if 0 <= i < shape[1]:
        cache.to_local()[:, i] = local_new


# ---------------------------------------------------------------------------
# Products of DTensors, sharded by their letters
# ---------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _matmul_equation(a_dim: int, b_dim: int) -> str:
    """The einsum of ``a @ b`` for a (..., m, k) and b (k, n) or a
    batched (..., k, n)."""
    if b_dim == 1 or a_dim == 1:
        raise NotImplementedError("matmul with a vector operand")
    batch = _LETTERS[4:4 + max(a_dim, b_dim) - 2]
    a_b, b_b = batch[len(batch) - (a_dim - 2):], batch[len(batch) - (b_dim - 2):]
    return f"{a_b}mk,{b_b}kn->{batch}mn"


def einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)``; of DTensors ``sharded_einsum``."""
    if any(is_dtensor(o) for o in operands):
        return sharded_einsum(eq, *operands)
    return torch.einsum(eq, *operands)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)``; of DTensors of two dims or more
    ``sharded_einsum`` of its equation, each rank's product a
    ``torch.matmul`` of its shards."""
    if (is_dtensor(a) or is_dtensor(b)) and a.dim() >= 2 and b.dim() >= 2:
        return sharded_einsum(_matmul_equation(a.dim(), b.dim()), a, b,
                              local=torch.matmul)
    return torch.matmul(a, b)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)``; of DTensors ``sharded_einsum``, each rank's
    product a ``torch.bmm`` of its shards."""
    if is_dtensor(a) or is_dtensor(b):
        return sharded_einsum("bnk,bkm->bnm", a, b, local=torch.bmm)
    return torch.bmm(a, b)


def sharded_einsum(eq: str, *operands,
                   local: Optional[Callable[..., torch.Tensor]] = None):
    """``torch.einsum(eq, *operands)`` of DTensors as each rank computes
    it: one local product on local shards (``local(*shards)``, by
    default ``torch.einsum(eq, *shards)``).  Per mesh dim one letter is
    sharded: among the letters the operands shard on that dim, the one
    whose choice gathers the fewest operand bytes; an operand that shards
    another letter there is gathered (an FSDP weight's all-gather), one
    that holds the letter unsharded there is sliced (free).  The result
    is sharded on the letter where the output keeps it and a partial sum
    where it is contracted."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    eq = eq.replace(" ", "")
    if "." in eq:
        eq = _expand_ellipsis(eq, operands)
    ins, out = eq.split("->")
    subs = ins.split(",")
    if "." in eq or len(subs) != len(operands):
        raise NotImplementedError(f"einsum {eq!r} on DTensors")
    mesh = next(o.device_mesh for o in operands if isinstance(o, DTensor))
    ops = [o if isinstance(o, DTensor) else
           DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                              run_check=False) for o in operands]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    size = {}
    for sub, o in zip(subs, ops):
        for ch, n in zip(sub, o.shape):
            size[ch] = n
    chosen: List[Optional[str]] = []
    for m in range(mesh.ndim):
        # a letter may be chosen again on a later mesh dim: rows sharded
        # over ("data", "model") jointly stay split over both
        cands = {sub[p.dim] for sub, o in zip(subs, ops)
                 for p in [o.placements[m]] if isinstance(p, Shard)}
        best, best_cost = None, None
        for c in sorted(cands):
            cost = sum(o.numel() * o.element_size()
                       for sub, o in zip(subs, ops)
                       if isinstance(o.placements[m], Shard)
                       and sub[o.placements[m].dim] != c)
            if best is None or cost < best_cost:
                best, best_cost = c, cost
        chosen.append(best)
    targets = []
    for sub, o in zip(subs, ops):
        pl = []
        for m, c in enumerate(chosen):
            pl.append(Shard(sub.index(c)) if c is not None and c in sub
                      else Replicate())
        targets.append(o if tuple(pl) == tuple(o.placements)
                       else o.redistribute(mesh, pl))
    # an operand whole on a mesh dim where another is split meets a
    # different shard on each rank there: its gradient is a partial sum
    # over that dim (to_local's default would take it as replicated)
    shards = [t.to_local(grad_placements=[
        Partial() if c is not None and isinstance(p, Replicate) else p
        for c, p in zip(chosen, t.placements)]) for t in targets]
    out_local = (local(*shards) if local is not None
                 else torch.einsum(eq, *shards))
    out_pl = [Replicate() if c is None else
              (Shard(out.index(c)) if c in out else Partial())
              for c in chosen]
    shape = torch.Size([size[ch] for ch in out])
    return DTensor.from_local(out_local, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _expand_ellipsis(eq: str, operands) -> str:
    """``eq`` with each "..." spelled out in unused letters."""
    ins, out = eq.split("->")
    subs = ins.split(",")
    free = [c for c in _LETTERS if c not in eq]
    n = max(o.dim() - (len(s) - 3) for s, o in zip(subs, operands)
            if "..." in s)
    fill = "".join(free[:n])
    subs = [s.replace("...", fill[n - (o.dim() - (len(s) - 3)):])
            for s, o in zip(subs, operands)]
    return ",".join(subs) + "->" + out.replace("...", fill)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= max(int(d), 1)
    return tuple(reversed(stride))


@contextlib.contextmanager
def dtensor_ops():
    """What a step on ``DTensor``s needs around it (the train step under
    a mesh, the paper's steps on a mesh, the dry run): plain tensors
    made inside the step (RoPE tables, masks, constants) taken as
    replicated.  Its products go through ``einsum`` / ``matmul`` /
    ``bmm`` at their call sites, whose operand moves are
    ``redistribute``s that autograd sees (a weight gathered for a
    product gets its gradient reduce-scattered back in the backward;
    inside DTensor's own bmm rule the gather is hidden and the gradient
    stays a whole partial sum), and which keep a batch dim split over
    two mesh dims (batch on "data", heads on "model") where DTensor's
    einsum rule, flattening the batch letters first, has none."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield
