"""Model configuration: one dataclass superset covering all 10 assigned
architectures (dense GQA, MLA+MoE, SSM, hybrid, enc-dec, VLM backbone)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # 'decoder' | 'encdec' | 'ssm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # ---- attention ----
    attn_kind: str = "gqa"          # 'gqa' | 'mla'
    qk_norm: bool = False           # qwen3
    rope_theta: float = 1e4
    rope_theta_global: float | None = None   # gemma3 global layers
    window: int | None = None       # sliding-window size for local layers
    global_every: int = 0           # gemma3: every k-th layer is global
    mrope_sections: tuple[int, ...] = ()     # qwen2-vl M-RoPE half-dim split
    use_rope: bool = True           # whisper uses absolute sinusoidal

    # ---- MLA (deepseek-v2) ----
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # ---- MLP / MoE ----
    mlp_kind: str = "swiglu"        # 'swiglu' | 'gelu' | 'moe'
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    dense_d_ff: int = 0

    # ---- SSM (mamba2 / zamba2) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    attn_every: int = 0             # zamba2: shared attn block cadence

    # ---- enc-dec (whisper backbone) ----
    enc_layers: int = 0
    enc_seq: int = 1500

    # ---- misc ----
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    post_norm: bool = False         # gemma3 sandwich norms
    norm_type: str = "rmsnorm"      # 'rmsnorm' | 'layernorm'
    param_dtype: str = "bfloat16"
    sub_quadratic: bool = False     # eligible for long_500k decode

    # -------------------------------------------------------------- derived
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    def layer_windows(self) -> list[int]:
        """Per-layer attention window; -1 means global (full causal)."""
        out = []
        for i in range(self.n_layers):
            if self.window is None:
                out.append(-1)
            elif self.global_every and (i + 1) % self.global_every == 0:
                out.append(-1)
            else:
                out.append(self.window)
        return out

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            di, ns = self.d_inner, self.ssm_state
            g = self.ssm_groups
            conv_dim = di + 2 * g * ns
            per = (d * (2 * di + 2 * g * ns + self.ssm_heads)  # in_proj
                   + conv_dim * self.conv_kernel               # conv
                   + di * d                                    # out_proj
                   + di + 2 * self.ssm_heads)                  # norm, A, D
            total = self.n_layers * per
            if self.attn_every:
                h = self.n_heads * self.head_dim
                total += (d * h * 4 + d * self.d_ff * 3)       # shared block
            return total + emb
        if self.attn_kind == "mla":
            attn = (d * self.q_dim                             # W_q
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            h, hk = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
            attn = d * (h + 2 * hk) + h * d
        if self.mlp_kind == "moe":
            moe = 3 * d * self.d_ff * (self.n_experts + self.n_shared_experts)
            moe += d * self.n_experts
            dense_layers = self.first_dense_layers
            mlp_total = ((self.n_layers - dense_layers) * moe
                         + dense_layers * 3 * d * self.dense_d_ff)
            mlp = 0
        else:
            act = self.dense_d_ff or self.d_ff
            del act
            mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            mlp_total = self.n_layers * mlp
        total = self.n_layers * attn + mlp_total + emb
        if self.family == "encdec":
            enc_attn = d * (self.n_heads * self.head_dim) * 4
            enc_mlp = 2 * d * self.d_ff
            cross = d * (self.n_heads * self.head_dim) * 4
            total += self.enc_layers * (enc_attn + enc_mlp)
            total += self.n_layers * cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.mlp_kind != "moe":
            return self.param_count()
        d = self.d_model
        full_moe = 3 * d * self.d_ff * (self.n_experts + self.n_shared_experts)
        active_moe = 3 * d * self.d_ff * (self.top_k + self.n_shared_experts)
        n_moe_layers = self.n_layers - self.first_dense_layers
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.attn_every else 7),
            d_model=128, d_ff=256, vocab_size=512,
            n_heads=max(2, min(4, self.n_heads)),
            head_dim=64,
            param_dtype="float32",
        )
        kw["n_kv_heads"] = min(self.n_kv_heads, kw["n_heads"])
        if self.attn_kind == "mla":
            kw.update(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                      v_head_dim=32)
        if self.mrope_sections:
            half = kw["head_dim"] // 2
            kw["mrope_sections"] = (half // 4, half // 4, half // 2)
        if self.mlp_kind == "moe":
            # capacity_factor 4.0: drop-free at smoke batch sizes, so the
            # prefill->decode parity tests are exact (production keeps 1.25)
            kw.update(n_experts=4, top_k=2, n_shared_experts=1,
                      first_dense_layers=min(1, self.first_dense_layers),
                      dense_d_ff=256, capacity_factor=4.0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=32, d_model=128)
            if self.attn_every:
                kw.update(attn_every=3)
        if self.family == "encdec":
            kw.update(enc_layers=2, enc_seq=32)
        if self.global_every:
            kw.update(window=16, global_every=2)
        return self.with_(**kw)


# shapes assigned to the LM pool (seq_len, global_batch, kind)
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
