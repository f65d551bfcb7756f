"""whisper-tiny [audio]: enc-dec transformer backbone, conv frontend STUB.

[arXiv:2212.04356; unverified] 4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  The audio frontend (2x conv + GELU) is stubbed per the
assignment: input_specs() feeds precomputed 1500-frame encoder embeddings.
Decoder uses absolute sinusoidal positions (no RoPE); full attention, so
long_500k is skipped (see DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    mlp_kind="gelu", norm_type="layernorm", use_rope=False,
    enc_layers=4, enc_seq=1500, tie_embeddings=True,
    sub_quadratic=False,
)
