"""GQA attention: init + prefill/decode — the port of
``repro/models/attention.py``.

:func:`attn_forward` (full-sequence causal attention) always goes through
the flash_attention kernel wrapper: the reference's ``use_pallas`` switch
has no counterpart, and its plain ``_sdpa`` stays for the bidirectional
callers.  :func:`attn_decode` is plain torch, as in the reference, which
has no kernel there.  A window of -1 (or None) means global.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from .common import (apply_rope, dense_spec, materialize, norm, norm_params,
                     rms_norm)

NEG_INF = -1e30


def attn_specs(cfg) -> dict:
    d = cfg.d_model
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    p = {"wq": dense_spec((d, h * dh), dt), "wk": dense_spec((d, hk * dh), dt),
         "wv": dense_spec((d, hk * dh), dt), "wo": dense_spec((h * dh, d), dt)}
    if cfg.qk_norm:
        p["q_norm"] = ("ones", (dh,), dt)
        p["k_norm"] = ("ones", (dh,), dt)
    return p


def init_attn(cfg, gen: torch.Generator) -> dict:
    return materialize(attn_specs(cfg), gen)


def _project_qkv(cfg, p, x, positions, theta):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hk, dh)
    v = (x @ p["wv"]).reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, theta, cfg.mrope_sections)
        k = apply_rope(k, positions, theta, cfg.mrope_sections)
    return q, k, v


def _window_mask(qi: torch.Tensor, kj: torch.Tensor, window) -> torch.Tensor:
    if window is None or window < 0:
        return torch.ones_like(qi - kj, dtype=torch.bool)
    return (qi - kj) < window


def _sdpa(q, k, v, *, causal: bool, window=-1, q_offset: int = 0):
    """Plain masked softmax attention.  q: [B,S,H,Dh]; k,v: [B,T,Hk,Dh]."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * (dh ** -0.5)
    qi = (torch.arange(s, device=q.device) + q_offset)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = _window_mask(qi, kj, window)
    if causal:
        mask = mask & (kj <= qi)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def attn_forward(cfg, p, x, positions, theta, window):
    """Full-sequence causal attention (prefill) through the flash_attention
    kernel.  Returns (out [B,S,D], (k, v) for the cache)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, theta)
    win = int(window) if window is not None and int(window) > 0 else None
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=win)
    out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, (k, v)


def attn_decode(cfg, p, x, pos, theta, window, k_cache, v_cache):
    """Single-step decode.  x: [B,1,D]; pos: [B] current index;
    k_cache/v_cache: [B, Smax, Hk, Dh], written in place at ``pos`` (the
    reference returns updated copies).  Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    positions = pos[:, None]                                   # [B,1]
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, 1, 3)
    q, k, v = _project_qkv(cfg, p, x, positions, theta)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    t = k_cache.shape[1]
    hk, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, hk, g, cfg.head_dim)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k_cache.float()) * (cfg.head_dim ** -0.5)
    kj = torch.arange(t, device=x.device)[None, :]
    mask = (kj <= pos[:, None]) & _window_mask(pos[:, None], kj, window)
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", probs, v_cache.float()).to(x.dtype)
    out = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, k_cache, v_cache


def block_norm_specs(cfg) -> dict:
    p = {"attn_norm": norm_params(cfg, cfg.d_model),
         "mlp_norm": norm_params(cfg, cfg.d_model)}
    if cfg.post_norm:
        p["post_attn_norm"] = norm_params(cfg, cfg.d_model)
        p["post_mlp_norm"] = norm_params(cfg, cfg.d_model)
    return p


def init_block_norms(cfg, gen: torch.Generator) -> dict:
    return materialize(block_norm_specs(cfg), gen)


def block_norm(cfg, p, name, x):
    return norm(cfg, x, p[name])
