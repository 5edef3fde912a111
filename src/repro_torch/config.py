"""Configuration dataclasses: copies of the JAX package's
``ModelConfig``, ``ParallelConfig``, ``TrainConfig`` and
``CausalConfig``.

Field for field the same as the JAX package's classes (same names,
order and defaults), so a configuration written for one package runs
unchanged in the other.  Where the reference holds a ``jnp`` dtype, the
port holds the ``torch`` dtype of the same name.  ``ShapeConfig`` and
its four shape cells (``SHAPES``, ``SHAPE_BY_NAME``) are the reference's
too: the production cells of ``launch/cells.py`` and the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one per assigned arch)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    attention: str = "gqa"  # gqa | mla | rwkv | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # fraction of head_dim that rotates
    use_rope: bool = True
    learned_pos_emb: bool = False  # whisper
    max_position_embeddings: int = 1 << 20
    logits_softcap: float = 0.0

    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ---
    mlp: str = "swiglu"  # swiglu | gelu

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    dense_residual: bool = False
    first_k_dense: int = 0
    dense_ff: int = 0
    router_aux_loss: float = 0.001
    router_score: str = "softmax"  # softmax | sigmoid
    expert_capacity_factor: float = 1.25
    mtp_depth: int = 0

    # --- SSM / hybrid (zamba2, rwkv6) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_every: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    max_source_positions: int = 1500

    # --- vlm (pixtral) ---
    patch_embed_dim: int = 0

    # --- numerics ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def is_subquadratic(self) -> bool:
        """SSM and hybrid families mix the sequence sub-quadratically."""
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Embedding rows, padded to a multiple of 256 as the reference
        pads them (its tables shard the vocab dim)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        """Whisper-style encoder-decoder."""
        return self.encoder_layers > 0

    @property
    def q_dim(self) -> int:
        """Width of the concatenated query heads."""
        if self.attention == "mla":
            return self.num_heads * (self.qk_nope_head_dim
                                     + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for i in range(L):
            n += self._layer_params(i)
        if self.is_encdec:
            for _ in range(self.encoder_layers):
                n += self._enc_layer_params()
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            n += self._layer_params(i, active_only=True)
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            n = d * self.q_lora_rank if self.q_lora_rank else 0
            qin = self.q_lora_rank or d
            n += qin * self.num_heads * (self.qk_nope_head_dim
                                         + self.qk_rope_head_dim)
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            n += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim
                                                       + self.v_head_dim)
            n += self.num_heads * self.v_head_dim * d
            return n
        if self.attention == "rwkv":
            return 5 * d * d + d * 64 * 2
        nq = d * self.num_heads * self.head_dim
        nkv = 2 * d * self.num_kv_heads * self.head_dim
        no = self.num_heads * self.head_dim * d
        return nq + nkv + no

    def _mlp_params(self, ff: int) -> int:
        mult = 3 if self.mlp == "swiglu" else 2
        return mult * self.d_model * ff

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if self.family == "ssm":
            return n + self._attn_params() + self._mlp_params(self.d_ff)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            n += 2 * d * di + di * self.ssm_state * 2 + di * self.ssm_conv + di
            if self.shared_attn_every:
                shared = (self._attn_params() + self._mlp_params(self.d_ff)
                          + 2 * d)
                n += shared // max(1, self.num_layers)
            return n
        n += self._attn_params()
        if self.num_experts and i >= self.first_k_dense:
            per_expert = self._mlp_params(self.d_ff)
            k = self.experts_per_token if active_only else self.num_experts
            n += per_expert * k + per_expert * self.num_shared_experts
            n += self.d_model * self.num_experts  # router
            if self.dense_residual:
                n += self._mlp_params(self.d_ff)
        else:
            n += self._mlp_params(self.dense_ff or self.d_ff)
        return n

    def _enc_layer_params(self) -> int:
        return (self._attn_params() + self._mlp_params(self.d_ff)
                + 4 * self.d_model)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per arch)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model runs (the reference's perf knobs; the port reads
    ``use_flash_attention`` and ``attention_impl``)."""

    fsdp: bool = True
    sequence_parallel: bool = False
    remat_policy: str = "nothing"  # nothing | dots | full_save
    scan_layers: bool = True
    gradient_compression: str = "none"  # none | bf16 | int8
    shard_kv_seq: bool = False
    adam_moment_dtype: Any = torch.float32
    grad_accum_dtype: Any = torch.float32
    use_flash_attention: bool = False  # the hand-written flash kernel
    attention_impl: str = "dense"  # dense | chunked
    attention_chunk: int = 1024
    microbatch: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer hyper-parameters (``optim.adamw``; the mlp nuisance's
    full-batch AdamW).  ``b2`` is 0.95, not torch's 0.999."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CausalConfig:
    """DML estimator configuration (the paper's §5 case study)."""

    n_folds: int = 5
    nuisance_y: str = "ridge"  # ridge | mlp | backbone
    nuisance_t: str = "logistic"  # logistic | mlp | backbone
    final_stage: str = "linear"  # linear CATE: theta(x) = <beta, phi(x)>
    cate_features: int = 1  # phi(x) dims (1 => ATE-only / constant effect)
    ridge_lambda: float = 1e-3
    newton_iters: int = 16
    # 0 = whole-array moments; R > 0 = row blocks of R reduced in fixed
    # left-to-right order (core.moments).
    row_block: int = 0
    # Blocked-evaluation strategy at row_block > 0: "chunked" streams one
    # block at a time, "whole" materializes every block partial first
    # (bitwise equal to chunked), "pallas" routes the Gram-shaped forms
    # through the fused segment-Gram kernel (the name is kept from the
    # JAX package; here it is the CUDA kernel of kernels/seg_gram).
    row_block_strategy: str = "chunked"  # chunked | whole | pallas
    mlp_hidden: Tuple[int, ...] = (256, 256)
    mlp_steps: int = 200
    mlp_lr: float = 1e-3
    discrete_treatment: bool = True
    engine: str = "parallel"  # parallel | sequential | parallel_loo
    # --- instrumental variables ---
    nuisance_z: str = "logistic"
    discrete_instrument: bool = True
    iv_cov_clip: float = 0.1
    # --- uncertainty quantification ---
    inference: str = "bootstrap"  # bootstrap | multiplier | jackknife | none
    n_bootstrap: int = 200
    alpha: float = 0.05
    inference_executor: str = "vmap"  # serial | vmap | shard_map
    # --- task-graph runtime ---
    runtime_memory_budget: int = 0
    runtime_chunk: int = 0
    runtime_max_retries: int = 2
    # --- segment-parallel sweeps ---
    segment_key: str = ""
    sweep_chunk: int = 0


def smoke_variant(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        max_position_embeddings=512,
    )
    if cfg.attention == "mla":
        base.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_head_dim=8,
                    qk_nope_head_dim=8, v_head_dim=16)
    if cfg.num_experts:
        base.update(num_experts=4, experts_per_token=2,
                    num_shared_experts=min(cfg.num_shared_experts, 1),
                    first_k_dense=min(cfg.first_k_dense, 1),
                    dense_ff=128 if cfg.dense_ff else 0,
                    expert_capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=8, ssm_chunk=16)
    if cfg.shared_attn_every:
        base.update(shared_attn_every=1, num_layers=2)
    if cfg.is_encdec:
        base.update(encoder_layers=2, max_source_positions=64)
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
