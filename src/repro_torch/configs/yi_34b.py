"""yi-34b — dense llama-arch GQA [arXiv:2403.04652; hf:01-ai/Yi-34B]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    mlp="swiglu",
    rope_theta=5_000_000.0,
)
