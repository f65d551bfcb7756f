"""deepseek-v2-236b [moe]: [arXiv:2405.04434; hf]
60L d_model=5120 128H, MLA kv_lora=512, MoE: 160 routed experts top-6 +
2 shared, expert d_ff=1536, first layer dense (d_ff 12288), vocab=102400."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="decoder",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    mlp_kind="moe", n_experts=160, n_shared_experts=2, top_k=6,
    first_dense_layers=1, dense_d_ff=12288,
    rope_theta=10000.0, tie_embeddings=False, sub_quadratic=False,
)
