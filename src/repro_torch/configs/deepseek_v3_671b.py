"""deepseek-v3-671b — MLA attention, 1 shared + 256 routed experts top-8,
sigmoid router, first-3-dense, optional MTP [arXiv:2412.19437]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,  # routed expert intermediate size
    vocab_size=129_280,
    attention="mla",
    mlp="swiglu",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    first_k_dense=3,
    dense_ff=18432,
    router_score="sigmoid",
    mtp_depth=0,  # MTP head available via flag; off for shape cells
)
