"""phi4-mini-3.8b — dense, partial RoPE, SwiGLU, GQA [arXiv:2412.08905]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    attention="gqa",
    mlp="swiglu",
    rope_theta=10_000.0,
    rope_fraction=0.75,  # partial_rotary_factor
    tie_embeddings=True,
)
