"""zamba2-1.2b [hybrid]: [arXiv:2411.15242; hf] Mamba2 backbone + SHARED
attention block cadence.  38L d_model=2048, shared attn 32H (kv=32,
head_dim 64), d_ff=8192 (shared block MLP), vocab=32000, ssm_state=64.
Simplification noted in DESIGN.md: the shared transformer block (one
weight set reused every 6 mamba layers) runs on the residual stream
directly (Zamba's concat-with-embedding + per-use LoRA is omitted).
State-space backbone -> eligible for long_500k decode."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_groups=1, expand=2, conv_kernel=4,
    attn_every=6, tie_embeddings=True, sub_quadratic=True,
)
