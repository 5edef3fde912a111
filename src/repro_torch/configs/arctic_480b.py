"""arctic-480b — MoE 128 experts top-2 with a dense residual MLP in
parallel (dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base]."""
import torch

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    attention="gqa",
    mlp="swiglu",
    num_experts=128,
    experts_per_token=2,
    dense_residual=True,
    expert_capacity_factor=1.25,
    param_dtype=torch.float32,  # set explicitly, as the reference's config
)
