"""qwen2-vl-2b [vlm]: [arXiv:2409.12191; hf] M-RoPE, dynamic resolution.
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
BACKBONE ONLY per the assignment: the ViT frontend is a STUB —
input_specs() feeds precomputed patch embeddings; M-RoPE runs with its
(16, 24, 24) temporal/height/width half-dim sections on stub positions."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="decoder",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True, sub_quadratic=False,
)
