"""mamba2-130m [ssm]: [arXiv:2405.21060; unverified] SSD (state-space
duality).  24L d_model=768 (attn-free) vocab=50280, ssm_state=128,
expand=2 (d_inner 1536, 24 heads of P=64).  O(1)-state decode ->
eligible for long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, expand=2, conv_kernel=4,
    tie_embeddings=True, sub_quadratic=True,
)
