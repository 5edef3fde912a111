"""chatglm3-6b — dense, 2d (interleaved, half-dim) RoPE, GQA kv=2
[arXiv:2406.12793; hf:THUDM/chatglm3-6b]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    attention="gqa",
    mlp="swiglu",
    rope_theta=10_000.0,
    rope_fraction=0.5,  # GLM rotates half of head_dim, interleaved pairs
)
