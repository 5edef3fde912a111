"""rwkv6-3b — "Finch": attention-free time-mix with data-dependent decay
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,   # 2560 / 64 per-head channels
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention="rwkv",
    mlp="gelu",  # unused: rwkv channel-mix replaces the MLP
    use_rope=False,
    ssm_chunk=16,  # stability bound: chunk * MAX_LOG_DECAY must stay in fp32 exp range
)
