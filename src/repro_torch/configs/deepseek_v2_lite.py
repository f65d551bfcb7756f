"""deepseek-v2-lite-16b [moe]: [arXiv:2405.04434; hf]
27L d_model=2048 16H, MLA kv_lora=512 (qk_nope 128 + qk_rope 64, v 128),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer
dense (d_ff 10944), vocab=102400."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="decoder",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    mlp_kind="moe", n_experts=64, n_shared_experts=2, top_k=6,
    first_dense_layers=1, dense_d_ff=10944,
    rope_theta=10000.0, tie_embeddings=False, sub_quadratic=False,
)
