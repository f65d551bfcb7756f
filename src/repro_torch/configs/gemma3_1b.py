"""gemma3-1b [dense]: [hf:google/gemma-3-1b-pt; unverified]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global attention (512-token sliding window locally), dual RoPE
theta (10k local / 1M global), sandwich (pre+post) RMSNorm, tied embeddings.
Sliding-window dominated -> eligible for long_500k decode (the 1-in-6
global layers still attend the full cache; decode remains O(n)/step)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="decoder",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    window=512, global_every=6, rope_theta=10000.0,
    rope_theta_global=1000000.0, post_norm=True,
    tie_embeddings=True, sub_quadratic=True,
)
