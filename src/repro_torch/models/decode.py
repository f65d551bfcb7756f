"""Single-step decode and the cache constructor for all four families —
the port of ``repro/models/decode.py``.

The cache layout is the reference's: the decoder's ``k``/``v``
``[L, B, S, Hk, Dh]``, or with MLA the latents ``ckv [L, B, S, lora]`` and
``kr [L, B, S, rope]`` of the stacked layers and ``d_ckv``/``d_kr`` of the
dense ones; the ssm and hybrid families' ``conv [L, B, k-1, C]``
(pre-conv features), ``state [L, B, H, N, P]`` fp32 and ``attn_k``/
``attn_v`` ``[apps, B, S, Hk, Dh]`` (one per shared-attention
application); whisper's ``k``/``v`` and ``cross_k``/``cross_v``
``[L, B, T, Hk, Dh]`` (T: the encoder's frames padded to a whole page,
``blocks.cross_rows``); and ``pos``.  :func:`decode_step` updates the cache tensors
in place (the reference returns updated copies) and returns a new dict
holding them.  Every GQA attention layer of a step runs the
paged_attention kernel over its cache through one page table
(``attention.decode_pages``); a local layer (gemma3's sliding window)
reads only its window's tokens, a global one its whole prefix.
whisper's cross attention runs the same kernel over the cross cache's
page view with every length at the encoder's frame count (the pad rows
are never read).  MLA decodes in plain torch, absorbed or expanded, as the
reference does.
"""

from __future__ import annotations

import torch

from ..core.types import resolve_compute_device
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssd as ssd_mod
from ..kernels.paged_attention import paged_attention
from .blocks import (check_params_device, cross_rows, decoder_layers,
                     exact_fp32, layer_params, mlp_step, require_ported,
                     scale_embeds, segments)
from .common import dtype_of, norm, sinusoidal_positions


def cache_shapes(cfg, batch: int, max_seq: int) -> dict:
    """name -> (shape, dtype) of every tensor of :func:`init_cache`, without
    allocating anything (``launch.specs.decode_specs`` reads them at sizes
    no device holds)."""
    require_ported(cfg)
    dt = dtype_of(cfg)
    pos = ((1,), torch.int32)
    if cfg.family == "encdec":
        kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
              dt)
        cross = ((cfg.n_layers, batch, cross_rows(cfg), cfg.n_kv_heads,
                  cfg.head_dim), dt)
        return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross,
                "pos": pos}
    if cfg.family == "decoder":
        n_scan = cfg.n_layers - cfg.first_dense_layers
        if cfg.attn_kind == "mla":
            shapes = {}
            for pre, n in (("", n_scan), ("d_", cfg.first_dense_layers)):
                if n:
                    shapes[pre + "ckv"] = ((n, batch, max_seq,
                                            cfg.kv_lora_rank), dt)
                    shapes[pre + "kr"] = ((n, batch, max_seq,
                                           cfg.qk_rope_dim), dt)
        else:
            kv = ((n_scan, batch, max_seq, cfg.n_kv_heads, cfg.head_dim), dt)
            shapes = {"k": kv, "v": kv}
        shapes["pos"] = pos
        return shapes
    shapes = {
        "conv": ((cfg.n_layers, batch, cfg.conv_kernel - 1,
                  ssd_mod.conv_dim(cfg)), dt),
        "state": ((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                   cfg.ssm_head_dim), torch.float32),
        "pos": pos,
    }
    if cfg.attn_every:
        n_apps = len(range(cfg.attn_every, cfg.n_layers, cfg.attn_every))
        kv = ((n_apps, batch, max_seq, cfg.n_kv_heads, cfg.head_dim), dt)
        shapes["attn_k"] = shapes["attn_v"] = kv
    return shapes


def init_cache(cfg, batch: int, max_seq: int, *,
               compute_device: str | torch.device = "cuda") -> dict:
    """Zero tensors of :func:`cache_shapes` on ``compute_device``."""
    dev = resolve_compute_device(compute_device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_shapes(cfg, batch, max_seq).items()}


def decode_step(cfg, params, tokens, pos, cache, *, batch_extras=None,
                absorbed_mla: bool = True,
                compute_device: str | torch.device = "cuda"):
    """tokens: [B, 1] int; pos: [B] int write index; cache: as
    :func:`init_cache`; ``absorbed_mla`` picks MLA's decode form.  Returns
    (logits [B, 1, V], new_cache).  ``batch_extras`` is the reference's
    argument, which it ignores too (whisper's encoder output lives in the
    cross cache)."""
    del batch_extras
    require_ported(cfg)
    dev = resolve_compute_device(compute_device)
    check_params_device(params, dev)
    exact_fp32()
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    h = scale_embeds(cfg, params["embed"][tokens])
    if cfg.family == "encdec":
        h = _decode_encdec(cfg, params, h, pos, cache)
    elif cfg.family == "decoder":
        h = _decode_decoder(cfg, params, h, pos, cache, absorbed_mla)
    else:
        h = _decode_ssm(cfg, params, h, pos, cache)
    h = norm(cfg, h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    return h @ head, new_cache


def _decode_decoder(cfg, params, h, pos, cache, absorbed_mla):
    mla = cfg.attn_kind == "mla"
    pages = None if mla else attn.decode_pages(pos, cache["k"].shape[2])
    for lp, theta, window, dense, i in decoder_layers(cfg, params):
        a_in = norm(cfg, h, lp["attn_norm"])
        if mla:
            pre = "d_" if dense else ""
            a_out, _, _ = mla_mod.mla_decode(
                cfg, lp["attn"], a_in, pos, cache[pre + "ckv"][i],
                cache[pre + "kr"][i], absorbed=absorbed_mla)
        else:
            a_out, _, _ = attn.attn_decode(
                cfg, lp["attn"], a_in, pos, theta, window, cache["k"][i],
                cache["v"][i], pages)
        if cfg.post_norm:
            a_out = norm(cfg, a_out, lp["post_attn_norm"])
        h = mlp_step(cfg, lp, h + a_out, dense=dense)
    return h


def _decode_ssm(cfg, params, h, pos, cache):
    pages = (attn.decode_pages(pos, cache["attn_k"].shape[2])
             if cfg.attn_every else None)
    app = 0
    for seg_start, seg_end in segments(cfg):
        for i in range(seg_start, seg_end):
            lp = layer_params(params["layers"], i)
            out, conv, state = ssd_mod.ssd_decode(
                cfg, lp["ssd"], norm(cfg, h, lp["norm"]), cache["conv"][i],
                cache["state"][i])
            cache["conv"][i] = conv
            cache["state"][i] = state
            h = h + out
        if cfg.attn_every and seg_end < cfg.n_layers:
            lp = params["shared_attn"]
            a_out, _, _ = attn.attn_decode(
                cfg, lp["attn"], norm(cfg, h, lp["attn_norm"]), pos,
                cfg.rope_theta, -1, cache["attn_k"][app],
                cache["attn_v"][app], pages)
            h = h + a_out
            h = h + moe_mod.mlp_forward(cfg, lp["mlp"],
                                        norm(cfg, h, lp["mlp_norm"]))
            app += 1
    return h


def _decode_encdec(cfg, params, h, pos, cache):
    # sinusoidal_positions(S)[p] depends on p alone: the table is built to
    # the self cache's length, as the reference builds it
    pe = sinusoidal_positions(cache["k"].shape[2], cfg.d_model,
                              device=h.device)
    h = h + pe[pos][:, None, :].to(h.dtype)
    b, rows = h.shape[0], cache["cross_k"].shape[2]
    pages = attn.decode_pages(pos, cache["k"].shape[2])
    ps = attn.PAGE_TOKENS
    cross_table = attn._identity_table(b, rows // ps, h.device)
    cross_len = torch.full((b,), cfg.enc_seq, dtype=torch.int32,
                           device=h.device)
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        a_out, _, _ = attn.attn_decode(
            cfg, lp["attn"], norm(cfg, h, lp["attn_norm"]), pos,
            cfg.rope_theta, -1, cache["k"][i], cache["v"][i], pages)
        h = h + a_out
        p = lp["cross"]
        q = norm(cfg, h, lp["cross_norm"]) @ p["wq"]
        o = paged_attention(
            q.reshape(b, cfg.n_heads, dh),
            cache["cross_k"][i].view(b * rows // ps, ps, hk, dh),
            cache["cross_v"][i].view(b * rows // ps, ps, hk, dh),
            cross_table, cross_len)
        h = h + o.reshape(b, 1, cfg.n_heads * dh) @ p["wo"]
        h = h + moe_mod.mlp_forward(cfg, lp["mlp"],
                                    norm(cfg, h, lp["mlp_norm"]))
    return h
