"""yi-6b [dense]: [arXiv:2403.04652; hf] llama-arch GQA
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="decoder",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, rope_theta=5000000.0,
    tie_embeddings=False, sub_quadratic=False,
)
