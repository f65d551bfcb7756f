"""Multi-head Latent Attention (DeepSeek-V2): prefill and the two decode
forms — the port of ``repro/models/mla.py``.

MLA compresses KV into a per-token latent ``c_kv`` (kv_lora_rank wide) plus
one shared RoPE key head; the cache holds only ``(c_kv, k_rope)``.  Decode
comes in the reference's two mathematically identical forms: ``expand``
(up-project the cached latents to per-head K/V every step) and
``absorbed`` (fold W_uk into the query and W_uv into the output, so that
attention runs in the latent space).  Both, and the prefill, are plain
torch in fp32 logits as in the reference, which computes them outside any
Pallas kernel: no attention kernel runs on this path.
"""

from __future__ import annotations

import torch

from .common import apply_rope, dense_spec, materialize, rms_norm

NEG_INF = -1e30


def mla_specs(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                            cfg.v_head_dim, cfg.kv_lora_rank)
    dt = cfg.param_dtype
    return {"wq": dense_spec((d, h * (nope + rope)), dt),
            "w_dkv": dense_spec((d, lora), dt),
            "w_kr": dense_spec((d, rope), dt),
            "kv_norm": ("ones", (lora,), dt),
            "w_uk": dense_spec((lora, h * nope), dt),
            "w_uv": dense_spec((lora, h * vd), dt),
            "wo": dense_spec((h * vd, d), dt)}


def init_mla(cfg, gen: torch.Generator) -> dict:
    return materialize(mla_specs(cfg), gen)


def _project_q(cfg, p, x, positions):
    b, s, _ = x.shape
    nope = cfg.qk_nope_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, nope + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(cfg, p, x, positions):
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # [B,S,lora]
    k_rope = (x @ p["w_kr"])[:, :, None, :]                       # [B,S,1,r]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _attend(logits, mask, v):
    """Masked softmax of fp32 ``logits`` [B,H,S,T] (masked to -1e30, as the
    reference does) against ``v`` [B,T,H,Dv] fp32 -> [B,S,H,Dv]."""
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def mla_forward(cfg, p, x, positions):
    """Prefill: expand the latents to per-head K/V, full causal attention.
    Returns (out, (c_kv, k_rope)) for the cache."""
    b, s, _ = x.shape
    h, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, vd)
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * scale
    qi = torch.arange(s, device=x.device)
    mask = (qi[None, :] <= qi[:, None])[None, None]
    o = _attend(logits, mask, v.float())
    out = o.reshape(b, s, h * vd).to(x.dtype) @ p["wo"]
    return out, (c_kv, k_rope)


def mla_decode(cfg, p, x, pos, ckv_cache, kr_cache, *, absorbed: bool):
    """Single-step decode.  x: [B,1,D]; pos: [B]; ckv_cache: [B, Smax,
    lora] and kr_cache: [B, Smax, rope], written in place at ``pos`` (the
    reference returns updated copies).  Returns (out, ckv_cache,
    kr_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, vd, lora = cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    positions = pos[:, None]
    q_nope, q_rope = _project_q(cfg, p, x, positions)      # [B,1,H,*]
    c_kv, k_rope = _latents(cfg, p, x, positions)          # [B,1,lora|rope]
    rows = torch.arange(b, device=x.device)
    ckv_cache[rows, pos] = c_kv[:, 0]
    kr_cache[rows, pos] = k_rope[:, 0]
    t = ckv_cache.shape[1]
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    mask = (torch.arange(t, device=x.device)[None, :]
            <= pos[:, None])[:, None, None, :]              # [B,1,1,T]
    ckv = ckv_cache.float()
    rope_logits = torch.einsum("bshd,btd->bhst", q_rope.float(),
                               kr_cache.float())
    if absorbed:
        # q_lat[h] = q_nope[h] @ W_uk[h]^T: attention scored in latent space
        w_uk = p["w_uk"].reshape(lora, h, nope).float()
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope.float(), w_uk)
        logits = (torch.einsum("bshl,btl->bhst", q_lat, ckv)
                  + rope_logits) * scale
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhst,btl->bshl", probs, ckv)   # [B,1,H,lora]
        w_uv = p["w_uv"].reshape(lora, h, vd).float()
        o = torch.einsum("bshl,lhd->bshd", o_lat, w_uv)
    else:
        k_nope = (ckv_cache @ p["w_uk"]).reshape(b, t, h, nope)
        v = (ckv_cache @ p["w_uv"]).reshape(b, t, h, vd)
        logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(),
                               k_nope.float()) + rope_logits) * scale
        o = _attend(logits, mask, v.float())
    out = o.reshape(b, 1, h * vd).to(x.dtype) @ p["wo"]
    return out, ckv_cache, kr_cache
