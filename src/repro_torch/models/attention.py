"""GQA attention: init + train/prefill/decode — the port of
``repro/models/attention.py``.

:func:`attn_forward` (full-sequence causal attention) always goes through
the flash_attention kernel wrapper: the reference's ``use_pallas`` switch
has no counterpart; under autograd its gradient runs the
flash_attention_bwd kernel.  :func:`attn_decode` runs the paged_attention
kernel wrapper over the dense decode cache: ``[B, Smax, Hk, Dh]`` viewed
as ``B * Smax / PS`` pages of PS tokens (a view, not a copy) through an
identity page table, with ``lengths = pos + 1`` and the layer's window.
That is the reference's ``attn_decode`` exactly: its mask keeps ``kj <=
pos`` and, for
a window ``w``, ``pos - kj < w``, and the kernel visits only those live
tokens, ``[max(0, pos + 1 - w), pos + 1)`` (gemma3's local layers read
their window, not the prefix).  A window of -1 (or None) means global.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from .common import (apply_rope, dense_spec, materialize, norm, norm_params,
                     rms_norm)

#: tokens per page of the decode cache's page view (the serving block)
PAGE_TOKENS = 32


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


def attn_forward(cfg, p, x, positions, theta, window):
    """Full-sequence causal attention (train / prefill) through the
    flash_attention kernel (differentiable: its backward is the
    flash_attention_bwd kernel).  Returns (out [B,S,D], (k, v) for the
    cache); nothing is written in place."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, theta)
    win = int(window) if window is not None and int(window) > 0 else None
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=win)
    out = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, (k, v)


@functools.lru_cache(maxsize=16)
def _identity_table(b: int, maxp: int, device: torch.device) -> torch.Tensor:
    """[B, MAXP] int32: sequence b owns pages b * MAXP .. (b + 1) * MAXP - 1
    in order.  Read-only: every step of one shape shares it."""
    return torch.arange(b * maxp, dtype=torch.int32,
                        device=device).reshape(b, maxp)


def decode_pages(pos: torch.Tensor, max_seq: int) -> tuple:
    """The page view of a ``[B, max_seq, Hk, Dh]`` decode cache for a step
    at ``pos`` [B]: ``(page_size, page_table [B, max_seq / page_size] int32,
    lengths = pos + 1 int32)``.  Pages are PAGE_TOKENS long where that
    divides ``max_seq``, else one page holds the whole cache.  Built once
    per decode step and shared by its layers."""
    ps = PAGE_TOKENS if max_seq % PAGE_TOKENS == 0 else max_seq
    table = _identity_table(pos.shape[0], max_seq // ps, pos.device)
    return ps, table, (pos + 1).to(torch.int32)


def attn_decode(cfg, p, x, pos, theta, window, k_cache, v_cache, pages):
    """Single-step decode.  x: [B,1,D]; pos: [B] current index;
    k_cache/v_cache: [B, Smax, Hk, Dh], written in place at ``pos`` (the
    reference returns updated copies); ``pages``: :func:`decode_pages` of
    this step.  Attention runs through the paged_attention kernel wrapper,
    over the last ``window`` tokens for a window > 0.  Returns (out,
    k_cache, v_cache)."""
    b, smax = x.shape[0], k_cache.shape[1]
    positions = pos[:, None]                                   # [B,1]
    if cfg.mrope_sections:
        positions = positions[..., None].expand(b, 1, 3)
    q, k, v = _project_qkv(cfg, p, x, positions, theta)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    ps, table, lengths = pages
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    o = paged_attention(q[:, 0], k_cache.view(b * smax // ps, ps, hk, dh),
                        v_cache.view(b * smax // ps, ps, hk, dh), table,
                        lengths, window=window)
    out = o.reshape(b, 1, cfg.n_heads * dh) @ p["wo"]
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
