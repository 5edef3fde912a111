"""Estimator configuration: a torch-free copy of ``CausalConfig``.

Field for field the same as the JAX package's ``CausalConfig`` (same
names, order and defaults), so a configuration written for one package
runs unchanged in the other.  ``TrainConfig`` and ``ModelConfig`` come
with the LM-backbone slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
