"""llama3.2-3b [dense]: [hf:meta-llama/Llama-3.2-3B; unverified]
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="decoder",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0,
    tie_embeddings=True, sub_quadratic=False,
)
