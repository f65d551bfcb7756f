"""qwen3-1.7b [dense]: [hf:Qwen/Qwen3-1.7B; hf] qk_norm, GQA
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="decoder",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, rope_theta=1000000.0,
    qk_norm=True, tie_embeddings=True, sub_quadratic=False,
)
