"""Cell construction: one (architecture × input-shape × mesh) dry-run /
launch unit with its sharding policy (the reference's
``launch/cells.py``).

The policy encodes the TP/DP decisions a production launcher makes, all
derived from divisibility against the fixed production mesh
(data=16|32, model=16):

  * heads/kv_heads shard over "model" only when divisible by TP=16;
    otherwise attention falls back to sequence-sharded q (train/prefill)
    or sequence-sharded KV cache (decode).
  * train params use FSDP (embed dim over the DP axes) + TP; serving
    params shard their embed dim over the DP axes too, with TP.
  * decode caches shard batch over DP when divisible (decode_32k), else
    the cache's seq dim over DP (long_500k, batch=1).
  * sequence parallelism (residual seq over "model") is ON for train
    cells.
  * MoE giants (arctic/deepseek) train with bf16 params and moments.

``Cell.model()`` builds the cell's ``Model`` on fake CPU tensors (shapes
only), as the dry run does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import (ModelConfig, ParallelConfig, ShapeConfig,
                                SHAPE_BY_NAME)
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              PartitionSpec, ShardingRules,
                                              logical_to_spec)
from repro_torch.models.model import Model, build_model

TP = 16  # the "model" axis extent of the production mesh


def _div(a: int, b: int) -> bool:
    return a % b == 0


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    pcfg: ParallelConfig
    rules: ShardingRules
    multi_pod: bool

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape.name}"

    def model(self, device=None) -> Model:
        """The cell's model, its weights on ``device``; by default fake
        CPU tensors (``FakeTensorMode``: shapes and dtypes, nothing
        allocated), as the reference's weightless ``Model``."""
        if device is not None:
            return build_model(self.cfg, self.pcfg, self.rules,
                               device=device)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            return build_model(self.cfg, self.pcfg, self.rules,
                               device="cpu")


# ---------------------------------------------------------------------------
# Per-cell parallel policy
# ---------------------------------------------------------------------------

BF16_TRAIN_ARCHS = ("arctic-480b", "deepseek-v3-671b")  # HBM-bound giants


def cell_parallel_config(cfg: ModelConfig, shape: ShapeConfig,
                         overrides: Optional[Dict[str, Any]] = None
                         ) -> Tuple[ModelConfig, ParallelConfig]:
    kw: Dict[str, Any] = {}
    if shape.kind == "train":
        kw.update(fsdp=True, sequence_parallel=True, remat_policy="nothing",
                  attention_impl="chunked")
        # per-chip activation footprint scales with B/microbatch: the MoE
        # giants need grad accumulation to fit expert dispatch buffers
        if cfg.num_experts:
            kw.update(microbatch=8)
        elif cfg.param_count() > 20e9 or cfg.family in ("hybrid",):
            kw.update(microbatch=2)
        if cfg.name in BF16_TRAIN_ARCHS:
            kw.update(adam_moment_dtype=torch.bfloat16,
                      grad_accum_dtype=torch.bfloat16)
            cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    else:
        kw.update(fsdp=False, sequence_parallel=False)
        # serving checkpoints are bf16 (halves weight HBM + collective)
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        if shape.kind == "prefill":
            kw.update(attention_impl="chunked")
    if shape.name == "long_500k":
        kw.update(shard_kv_seq=True)
    kw.update(overrides or {})
    return cfg, ParallelConfig(**kw)


def cell_rules(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig,
               *, multi_pod: bool) -> ShardingRules:
    dp: Any = ("pod", "data") if multi_pod else "data"
    dp_size = 32 if multi_pod else 16
    train = shape.kind == "train"

    heads_ok = _div(cfg.num_heads, TP) and cfg.attention in ("gqa", "mla")
    kv_ok = _div(cfg.num_kv_heads, TP) and cfg.attention == "gqa"
    if cfg.attention == "mla":
        kv_ok = False  # latent cache has no head dim; see kv_seq below
    vocab_ok = _div(cfg.padded_vocab, TP)  # always true by construction
    batch_ok = _div(shape.global_batch, dp_size)

    # decode-cache seq placement: model axis when heads can't claim it,
    # DP axes for the long-context cell (batch=1 frees them)
    kv_seq: Any = None
    if shape.kind == "decode":
        if pcfg.shard_kv_seq and _div(shape.seq_len, dp_size):
            kv_seq = dp if not batch_ok else "model"
        elif not kv_ok and _div(shape.seq_len, TP):
            kv_seq = "model"

    # attention q-seq sharding replaces head-TP when heads don't divide
    attn_seq = None
    if not heads_ok and shape.kind in ("train", "prefill") \
            and cfg.attention in ("gqa", "mla") and _div(shape.seq_len, TP):
        attn_seq = "model"

    # weight placement: train = FSDP (embed over DP) + TP; serving shards
    # the weights' embed dim over the DP axes too (archs whose heads/kv
    # don't divide TP would otherwise replicate their attention weights
    # 16x); expert tensors stay EP over DP with expert_ff over "model"
    embed: Any = None
    if train and pcfg.fsdp:
        embed = dp
    elif not train:
        embed = dp

    r = [
        ("batch", dp if batch_ok else None),
        ("vocab", "model" if vocab_ok else None),
        ("heads", "model" if heads_ok else None),
        ("kv_heads", "model" if kv_ok else None),
        ("ff", "model"),
        ("experts", dp),
        ("expert_embed", None),
        ("expert_ff", "model"),
        ("embed", embed),
        ("embed_act", None),
        ("seq", "model" if pcfg.sequence_parallel else None),
        ("attn_seq", attn_seq),
        ("logits_seq", None),
        ("kv_seq", kv_seq),
        ("head_dim", None),
        ("state", None),
        ("layers", None),
        ("fold", None),
        ("qk_lora", None),
        ("inner", "model"),
        ("rows", dp),
    ]
    return ShardingRules(rules=tuple(r))


def make_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
              overrides: Optional[Dict[str, Any]] = None) -> Cell:
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    cfg, pcfg = cell_parallel_config(cfg, shape, overrides)
    rules = cell_rules(cfg, shape, pcfg, multi_pod=multi_pod)
    return Cell(arch=arch, shape=shape, cfg=cfg, pcfg=pcfg, rules=rules,
                multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# Shardings for the cell's inputs
# ---------------------------------------------------------------------------

def batch_pspecs(cell: Cell) -> Dict[str, PartitionSpec]:
    """PartitionSpecs mirroring Model.input_specs for train/prefill."""
    rules = cell.rules
    tok = logical_to_spec(("batch", None), rules)
    act3 = logical_to_spec(("batch", None, None), rules)
    return {"tokens": tok, "labels": tok, "patch_embeds": act3,
            "frames": act3}


_CACHE_AXES = {
    # leaf name -> logical axes for (layers, batch, ...) cache leaves
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "c_kv": ("layers", "batch", "kv_seq", None),
    "k_rope": ("layers", "batch", "kv_seq", None),
    "ssm": ("layers", "batch", "inner", None, None),
    "conv": ("layers", "batch", None, "inner"),
    "s": ("layers", "batch", None, None, None),
    "x_prev": ("layers", "batch", None, None),
}


def cache_pspecs(cell: Cell, cache_shapes) -> Any:
    """PartitionSpec tree mirroring the cache's dicts (``init_cache``).
    Leaf rules are keyed by leaf name; whisper's cross-KV (T_src=1500,
    indivisible) stays replicated along seq."""
    rules = cell.rules

    def leaf_spec(path, leaf):
        axes = list(_CACHE_AXES[path[-1]])
        if "cross" in path:
            axes = [a if a != "kv_seq" else None for a in axes]
        # mamba ssm head dim shards over model only when divisible
        if path[-1] == "ssm" and leaf.shape[2] % TP != 0:
            axes[2] = None
        return logical_to_spec(tuple(axes)[: len(leaf.shape)], rules)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path, node)

    return walk(cache_shapes, ())


def named(mesh, tree):
    """NamedShardings over a tree of PartitionSpecs."""
    if isinstance(tree, PartitionSpec):
        return NamedSharding(mesh, tree)
    return {k: named(mesh, v) for k, v in tree.items()}


def cell_input_shardings(cell: Cell, mesh):
    """(input specs, their NamedShardings) for the cell's entry point;
    ``Model.input_specs`` gives the specs ({name: (shape, dtype)}, the
    decode cache on the meta device)."""
    model = cell.model()
    specs = model.input_specs(cell.shape)
    if cell.shape.kind in ("train", "prefill"):
        ps = batch_pspecs(cell)
        return specs, {k: NamedSharding(mesh, ps[k]) for k in specs}
    # decode: {"tokens", "cache", "pos"}
    tok_spec = logical_to_spec(("batch", None), cell.rules)
    cache_sp = cache_pspecs(cell, specs["cache"])
    return specs, {"tokens": NamedSharding(mesh, tok_spec),
                   "cache": named(mesh, cache_sp),
                   "pos": NamedSharding(mesh, P())}
