"""pixtral-12b — VLM: pixtral-ViT frontend (STUB: the caller hands in
patch embeddings at d_model) + mistral-nemo decoder backbone
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,  # explicit head_dim (nemo): 32*128 = 4096 != d_model
    d_ff=14336,
    vocab_size=131_072,
    attention="gqa",
    mlp="swiglu",
    rope_theta=1_000_000_000.0,
    patch_embed_dim=1024,  # pixtral ViT hidden size; the forward never
    # reads it (the stub's embeddings are d_model wide)
)
