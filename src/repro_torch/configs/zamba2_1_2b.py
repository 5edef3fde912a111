"""zamba2-1.2b — hybrid: Mamba2 backbone + one weight-shared attention
block applied every 6 mamba blocks [arXiv:2411.15242; hf:Zyphra]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # shared attention block is MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attention="gqa",
    mlp="swiglu",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=16,  # stability bound: chunk * MAX_LOG_DECAY must stay in fp32 exp range
    shared_attn_every=6,
)
