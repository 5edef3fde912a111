"""whisper-tiny — encoder-decoder; conv/mel frontend STUBBED (the caller
hands in precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    attention="gqa",
    mlp="gelu",
    use_rope=False,
    learned_pos_emb=True,
    max_position_embeddings=32_768,  # stretched past whisper's 448, as the
    # reference's config stretches it
    encoder_layers=4,
    max_source_positions=1500,
    tie_embeddings=True,
)
