"""Model assembly: init, prefill and training forward for all four
families — the port of ``repro/models/blocks.py``.

Parameters are plain dicts with the reference's keys and its stacked
``[L, ...]`` layer layout; the layer stack runs as a Python loop where the
reference scans.

Families:
  decoder — GQA or MLA attention × dense SwiGLU or MoE MLP (qwen3,
            llama3.2, yi, qwen2-vl's backbone, gemma3 with its 5:1
            local:global sliding windows, deepseek-v2 with MLA, MoE
            routing and its first ``first_dense_layers`` layers dense,
            held apart as ``dense{i}`` before the stacked layers).
  ssm     — pure Mamba2 (SSD) stack.
  hybrid  — Mamba2 backbone with ONE shared attention block applied after
            every full ``attn_every``-layer segment (zamba2), each
            application with its own KV cache.
  encdec  — whisper: a bidirectional encoder over stub frame embeddings
            (flash_attention, non-causal) and a causal decoder with cross
            attention over the encoder's output (flash_attention with Sk =
            the encoder's frames), absolute sinusoidal positions.

``forward(mode="train")`` returns every position's logits and the MoE aux
loss, as the reference's does, for all four families; with ``remat`` each
stacked layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body), so its flash_attention or ssd_scan
forward runs again in the backward pass (the hybrid's shared attention
block, outside the reference's scanned body, is not recomputed).

Every entry point takes ``compute_device`` (default ``"cuda"``, which
raises without a GPU; ``"cpu"`` runs the kernels' plain versions) and runs
float32 products in full fp32 (TF32 off for matmul and cuDNN).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_compute_device
from ..kernels.flash_attention import flash_attention
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssd as ssd_mod
from .common import (dense_spec, materialize, norm, norm_params,
                     sinusoidal_positions, stack_specs)

Params = dict
Cache = dict
PORTED_FAMILIES = ("decoder", "ssm", "hybrid", "encdec")


def exact_fp32() -> None:
    """Keep float32 products in full fp32 on the card (no TF32), so that the
    float32 path is comparable with the CPU tier."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported: see "
            "ROADMAP.md, queue 1")


# ===================================================================== init
def model_specs(cfg) -> dict:
    """Leaf specs ``(kind, shape, dtype[, std])`` of every parameter, in the
    reference's pytree layout (see ``common.materialize``)."""
    require_ported(cfg)
    p = {"embed": dense_spec((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                             scale=0.02),
         "final_norm": norm_params(cfg, cfg.d_model)}
    if cfg.family == "encdec":
        return encdec_specs(cfg, p)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_spec((cfg.d_model, cfg.vocab_size),
                                  cfg.param_dtype)
    if cfg.family == "decoder":
        p["layers"] = stack_specs(decoder_block_specs(cfg, dense=False),
                                  cfg.n_layers - cfg.first_dense_layers)
        for i in range(cfg.first_dense_layers):
            p[f"dense{i}"] = decoder_block_specs(cfg, dense=True)
        return p
    block = {"norm": norm_params(cfg, cfg.d_model),
             "ssd": ssd_mod.ssd_specs(cfg)}
    p["layers"] = stack_specs(block, cfg.n_layers)
    if cfg.attn_every:
        p["shared_attn"] = {"attn_norm": norm_params(cfg, cfg.d_model),
                            "mlp_norm": norm_params(cfg, cfg.d_model),
                            "attn": attn.attn_specs(cfg),
                            "mlp": moe_mod.mlp_specs(cfg, d_ff=cfg.d_ff)}
    return p


def encdec_specs(cfg, p: dict) -> dict:
    """whisper's parameters beside ``embed`` and ``final_norm``: the
    encoder's final norm, its stacked blocks and the decoder's stacked
    blocks with their cross attention (no ``lm_head``: the logits use the
    embedding)."""
    p["enc_final_norm"] = norm_params(cfg, cfg.d_model)
    enc = {"attn_norm": norm_params(cfg, cfg.d_model),
           "mlp_norm": norm_params(cfg, cfg.d_model),
           "attn": attn.attn_specs(cfg), "mlp": moe_mod.mlp_specs(cfg)}
    dec = {"attn_norm": norm_params(cfg, cfg.d_model),
           "cross_norm": norm_params(cfg, cfg.d_model),
           "mlp_norm": norm_params(cfg, cfg.d_model),
           "attn": attn.attn_specs(cfg), "cross": attn.attn_specs(cfg),
           "mlp": moe_mod.mlp_specs(cfg)}
    p["encoder"] = stack_specs(enc, cfg.enc_layers)
    p["layers"] = stack_specs(dec, cfg.n_layers)
    return p


def decoder_block_specs(cfg, *, dense: bool) -> dict:
    """One decoder block: GQA or MLA attention, and an MoE MLP unless the
    model has none or the block is one of the first dense layers (d_ff
    ``dense_d_ff`` where given)."""
    p = attn.block_norm_specs(cfg)
    p["attn"] = (mla_mod.mla_specs(cfg) if cfg.attn_kind == "mla"
                 else attn.attn_specs(cfg))
    if cfg.mlp_kind == "moe" and not dense:
        p["mlp"] = moe_mod.moe_specs(cfg)
    else:
        d_ff = cfg.dense_d_ff if (dense and cfg.dense_d_ff) else cfg.d_ff
        p["mlp"] = moe_mod.mlp_specs(cfg, d_ff=d_ff)
    return p


def init_model(cfg, seed: int = 0, *,
               compute_device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``compute_device``."""
    dev = resolve_compute_device(compute_device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return materialize(model_specs(cfg), gen)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked ``[L, ...]`` layer parameters (views)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


# ================================================================== prefill
def layer_meta(cfg) -> list[tuple[float, int]]:
    """Per-layer (rope theta, window) as Python values (the reference's
    ``_layer_meta`` without tracers); a window of -1 means global."""
    out = []
    for w in cfg.layer_windows():
        theta = cfg.rope_theta
        if w < 0 and cfg.rope_theta_global is not None:
            theta = cfg.rope_theta_global
        out.append((theta, w))
    return out


def scale_embeds(cfg, h: torch.Tensor) -> torch.Tensor:
    """gemma multiplies its input embeddings by sqrt(d_model), rounded to
    their dtype as in the reference."""
    if cfg.name.startswith("gemma"):
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def _mlp_half(cfg, p, h, dense: bool):
    """The residual MLP half of a decoder block and its MoE aux loss (None
    for a dense MLP)."""
    m_in = norm(cfg, h, p["mlp_norm"])
    aux = None
    if cfg.mlp_kind == "moe" and not dense:
        m_out, aux = moe_mod.moe_forward(cfg, p["mlp"], m_in)
    else:
        m_out = moe_mod.mlp_forward(cfg, p["mlp"], m_in)
    if cfg.post_norm:
        m_out = norm(cfg, m_out, p["post_mlp_norm"])
    return h + m_out, aux


def mlp_step(cfg, p, h, *, dense: bool):
    """The residual MLP half of a decoder block (the reference's
    ``_mlp_step``): the MoE unless the model has none or the block is
    dense; the aux loss is dropped (decode has no use for it)."""
    return _mlp_half(cfg, p, h, dense)[0]


def _decoder_block_fwd(cfg, p, h, positions, theta, window, *, dense: bool):
    """(h, (k, v) or MLA's latents, MoE aux loss or None) of one decoder
    block."""
    a_in = norm(cfg, h, p["attn_norm"])
    if cfg.attn_kind == "mla":
        a_out, kv = mla_mod.mla_forward(cfg, p["attn"], a_in, positions)
    else:
        a_out, kv = attn.attn_forward(cfg, p["attn"], a_in, positions, theta,
                                      window)
    if cfg.post_norm:
        a_out = norm(cfg, a_out, p["post_attn_norm"])
    h, aux = _mlp_half(cfg, p, h + a_out, dense)
    return h, kv, aux


def _train_block(fn, remat: bool, *args):
    """``fn(*args)``, under activation checkpointing when ``remat``: its
    activations are dropped and recomputed in the backward pass."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def decoder_layers(cfg, params: Params) -> list[tuple]:
    """(parameters, rope theta, window, dense, cache index) of every
    decoder layer in order: the ``dense{i}`` blocks, then the stacked
    layers, each indexing its own cache stack (``d_ckv``/``d_kr`` or
    ``ckv``/``kr``, ``k``/``v``)."""
    meta = layer_meta(cfg)
    nd = cfg.first_dense_layers
    out = [(params[f"dense{i}"], *meta[i], True, i) for i in range(nd)]
    out += [(layer_params(params["layers"], j), *meta[nd + j], False, j)
            for j in range(cfg.n_layers - nd)]
    return out


def _decoder_forward(cfg, params, batch, dev, cache_len, mode, remat):
    tokens = batch.get("tokens")
    if tokens is not None:
        h = params["embed"][torch.as_tensor(tokens, device=dev).long()]
    else:
        h = torch.as_tensor(batch["embeds"], device=dev)
    h = scale_embeds(cfg, h)
    b, s = h.shape[0], h.shape[1]
    if cache_len is not None and cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(b, s, 3)
    else:
        positions = torch.as_tensor(positions, device=dev)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if mode == "train":
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        for lp, theta, window, dense, _ in decoder_layers(cfg, params):
            def block(lp, h, theta=theta, window=window, dense=dense):
                h, _, aux = _decoder_block_fwd(cfg, lp, h, positions, theta,
                                               window, dense=dense)
                return h, aux
            # the reference checkpoints its scanned layers, not the dense
            # ones before them
            h, aux = _train_block(block, remat and not dense, lp, h)
            if aux is not None:
                aux_total = aux_total + aux
        return norm(cfg, h, params["final_norm"]) @ head, aux_total
    kvs = {True: [], False: []}      # dense blocks' caches, the stack's
    for lp, theta, window, dense, _ in decoder_layers(cfg, params):
        h, kv, _ = _decoder_block_fwd(cfg, lp, h, positions, theta, window,
                                      dense=dense)
        kvs[dense].append(kv)
    h = norm(cfg, h, params["final_norm"])

    def grow(xs):                   # [L, B, S, ...] padded to cache_len
        x = torch.stack(xs)
        pad = [0, 0] * (x.dim() - 3) + [0, (cache_len or s) - s]
        return torch.nn.functional.pad(x, pad)
    cache: Cache = {}
    names = ("ckv", "kr") if cfg.attn_kind == "mla" else ("k", "v")
    for j, name in enumerate(names):
        cache[name] = grow([kv[j] for kv in kvs[False]])
    if cfg.attn_kind == "mla" and kvs[True]:
        for j, name in enumerate(names):
            cache[f"d_{name}"] = grow([kv[j] for kv in kvs[True]])
    cache["pos"] = torch.full((1,), s, dtype=torch.int32, device=dev)
    return h[:, -1:] @ head, cache


def _shared_attn_fwd(cfg, p, h, positions):
    a_in = norm(cfg, h, p["attn_norm"])
    a_out, kv = attn.attn_forward(cfg, p["attn"], a_in, positions,
                                  cfg.rope_theta, -1)
    h = h + a_out
    m_in = norm(cfg, h, p["mlp_norm"])
    return h + moe_mod.mlp_forward(cfg, p["mlp"], m_in), kv


def segments(cfg) -> list[tuple[int, int]]:
    """Layer ranges between shared-attention applications (one range for
    the ssm family)."""
    step = cfg.attn_every or cfg.n_layers
    return [(s, min(s + step, cfg.n_layers))
            for s in range(0, cfg.n_layers, step)]


def check_params_device(params: Params, dev: torch.device) -> None:
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters are on {params['embed'].device}, not "
                         f"on compute_device {dev}")


def forward(cfg, params: Params, batch: dict, *, mode: str = "prefill",
            remat: bool = True, cache_len: int | None = None,
            compute_device: str | torch.device = "cuda"):
    """mode='prefill': returns (last_logits [B, 1, V], cache) with the KV
    caches (the decoder's ``k``/``v`` [L, B, S, Hk, Dh], or for MLA the
    latents ``ckv`` [L, B, S, lora] and ``kr`` [L, B, S, rope] of the
    stacked layers and ``d_ckv``/``d_kr`` of the dense ones; the hybrid
    shared block's ``attn_k``/``attn_v``; whisper's ``k``/``v`` and its
    ``cross_k``/``cross_v`` [L, B, T, Hk, Dh], T the encoder's frames padded
    to a whole page, see :func:`cross_rows`) sized ``cache_len or S``.
    mode='train' (every family): returns (logits [B, S, V], MoE aux loss,
    0 without MoE) and writes no cache; ``remat`` recomputes each stacked
    layer's activations in the backward pass.  The reference's
    default mode is 'train'; the port's stays 'prefill', which its serving
    callers name.
    ``batch["tokens"]`` is [B, S] (a tensor or an array); the decoder
    family also takes ``batch["embeds"]`` [B, S, D] in its place and
    ``batch["positions"]`` ([B, S], or [B, S, 3] for M-RoPE); whisper
    takes ``batch["encoder_embeds"]`` [B, T, D]."""
    require_ported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', not {mode!r}")
    dev = resolve_compute_device(compute_device)
    check_params_device(params, dev)
    exact_fp32()
    if cfg.family == "decoder":
        return _decoder_forward(cfg, params, batch, dev, cache_len, mode,
                                remat)
    if cfg.family == "encdec":
        return _encdec_forward(cfg, params, batch, dev, cache_len, mode,
                               remat)
    return _ssm_forward(cfg, params, batch, dev, cache_len, mode, remat)


def _ssm_block_fwd(cfg, lp, h):
    """One Mamba2 layer of the training forward: h + its block's output."""
    return h + ssd_mod.ssd_forward(cfg, lp["ssd"], norm(cfg, h, lp["norm"]))[0]


def _ssm_forward(cfg, params, batch, dev, cache_len, mode, remat):
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    h = params["embed"][tokens]
    b, s = tokens.shape
    if cache_len is not None and cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if mode == "train":
        for seg_start, seg_end in segments(cfg):
            for i in range(seg_start, seg_end):
                h = _train_block(partial(_ssm_block_fwd, cfg), remat,
                                 layer_params(params["layers"], i), h)
            # the shared block sits outside the reference's scanned (and
            # checkpointed) layers
            if cfg.attn_every and seg_end < cfg.n_layers:
                h, _ = _shared_attn_fwd(cfg, params["shared_attn"], h,
                                        positions)
        return (norm(cfg, h, params["final_norm"]) @ head,
                torch.zeros((), dtype=torch.float32, device=dev))
    convs, states, kvs = [], [], []
    for seg_start, seg_end in segments(cfg):
        for i in range(seg_start, seg_end):
            lp = layer_params(params["layers"], i)
            out, conv_tail, state = ssd_mod.ssd_prefill(
                cfg, lp["ssd"], norm(cfg, h, lp["norm"]))
            h = h + out
            convs.append(conv_tail)
            states.append(state)
        if cfg.attn_every and seg_end < cfg.n_layers:
            h, kv = _shared_attn_fwd(cfg, params["shared_attn"], h, positions)
            kvs.append(kv)

    h = norm(cfg, h, params["final_norm"])
    logits = h[:, -1:] @ head
    cache: Cache = {"conv": torch.stack(convs), "state": torch.stack(states),
                    "pos": torch.full((1,), s, dtype=torch.int32,
                                      device=h.device)}
    if kvs:
        target = cache_len or s
        pad = (0, 0, 0, 0, 0, target - s)
        cache["attn_k"] = torch.nn.functional.pad(
            torch.stack([kv[0] for kv in kvs]), pad)
        cache["attn_v"] = torch.nn.functional.pad(
            torch.stack([kv[1] for kv in kvs]), pad)
    return logits, cache


# ================================================================== encdec
def cross_rows(cfg) -> int:
    """Rows of the cross-attention cache: the encoder's frames padded to a
    whole number of decode pages (1,500 -> 1,504), so that paged_attention
    reads it through the page view every decode cache has; the pad rows are
    never read (lengths stay at the frame count)."""
    ps = attn.PAGE_TOKENS
    return -(-cfg.enc_seq // ps) * ps


def _enc_block_fwd(cfg, p, h):
    """One encoder block: bidirectional self-attention through
    flash_attention (non-causal), then the MLP."""
    a_in = norm(cfg, h, p["attn_norm"])
    b, s, _ = a_in.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    q, k, v = attn._project_qkv(cfg, p["attn"], a_in, positions,
                                cfg.rope_theta)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=False)
    h = h + o.transpose(1, 2).reshape(b, s, -1) @ p["attn"]["wo"]
    return h + moe_mod.mlp_forward(cfg, p["mlp"],
                                   norm(cfg, h, p["mlp_norm"]))


def cross_kv(cfg, p, enc_out):
    """The cross attention's keys and values [B, T, Hk, Dh] from the
    encoder's output."""
    b = enc_out.shape[0]
    ck = (enc_out @ p["wk"]).reshape(b, -1, cfg.n_kv_heads, cfg.head_dim)
    cv = (enc_out @ p["wv"]).reshape(b, -1, cfg.n_kv_heads, cfg.head_dim)
    return ck, cv


def _cross_attn(cfg, p, x, enc_k, enc_v):
    """Cross attention of x [B, S, D] over the encoder's keys and values
    [B, T, Hk, Dh]: flash_attention, non-causal, Sq = S, Sk = T."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    o = flash_attention(q.transpose(1, 2), enc_k.transpose(1, 2),
                        enc_v.transpose(1, 2), causal=False)
    return o.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def encode(cfg, params: Params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over stub frame embeddings: [B, T, D] -> [B, T, D]."""
    h = enc_embeds + sinusoidal_positions(
        enc_embeds.shape[1], cfg.d_model,
        device=enc_embeds.device).to(enc_embeds.dtype)[None]
    for i in range(cfg.enc_layers):
        h = _enc_block_fwd(cfg, layer_params(params["encoder"], i), h)
    return norm(cfg, h, params["enc_final_norm"])


def _encdec_block(cfg, lp, h, positions, enc_out):
    """One decoder block: causal self-attention, cross attention over the
    encoder's output, MLP.  Returns (h, (k, v), (cross_k, cross_v))."""
    a_out, kv = attn.attn_forward(cfg, lp["attn"],
                                  norm(cfg, h, lp["attn_norm"]), positions,
                                  cfg.rope_theta, -1)
    h = h + a_out
    ck, cv = cross_kv(cfg, lp["cross"], enc_out)
    h = h + _cross_attn(cfg, lp["cross"], norm(cfg, h, lp["cross_norm"]),
                        ck, cv)
    h = h + moe_mod.mlp_forward(cfg, lp["mlp"], norm(cfg, h, lp["mlp_norm"]))
    return h, kv, (ck, cv)


def _encdec_forward(cfg, params, batch, dev, cache_len, mode, remat):
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    enc_out = encode(cfg, params, torch.as_tensor(batch["encoder_embeds"],
                                                  device=dev))
    b, s = tokens.shape
    if cache_len is not None and cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    h = params["embed"][tokens]
    h = h + sinusoidal_positions(s, cfg.d_model, device=dev).to(h.dtype)[None]
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    head = params["embed"].T
    if mode == "train":
        for i in range(cfg.n_layers):
            def block(lp, h, enc_out):
                return _encdec_block(cfg, lp, h, positions, enc_out)[0]
            h = _train_block(block, remat, layer_params(params["layers"], i),
                             h, enc_out)
        return (norm(cfg, h, params["final_norm"]) @ head,
                torch.zeros((), dtype=torch.float32, device=dev))
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        h, (k, v), (ck, cv) = _encdec_block(
            cfg, layer_params(params["layers"], i), h, positions, enc_out)
        ks.append(k)
        vs.append(v)
        cks.append(ck)
        cvs.append(cv)
    h = norm(cfg, h, params["final_norm"])
    target, t = cache_len or s, enc_out.shape[1]
    if t != cfg.enc_seq:       # decode reads enc_seq frames of the cache
        raise ValueError(f"{t} encoder frames, the config has "
                         f"{cfg.enc_seq}")
    pad_self = (0, 0, 0, 0, 0, target - s)
    pad_cross = (0, 0, 0, 0, 0, cross_rows(cfg) - t)
    cache: Cache = {
        "k": torch.nn.functional.pad(torch.stack(ks), pad_self),
        "v": torch.nn.functional.pad(torch.stack(vs), pad_self),
        "cross_k": torch.nn.functional.pad(torch.stack(cks), pad_cross),
        "cross_v": torch.nn.functional.pad(torch.stack(cvs), pad_cross),
        "pos": torch.full((1,), s, dtype=torch.int32, device=dev)}
    return h[:, -1:] @ head, cache


# ==================================================================== loss
def train_loss(cfg, params: Params, batch: dict, *, remat: bool = True,
               compute_device: str | torch.device = "cuda") -> torch.Tensor:
    """The mean next-token NLL over the labels >= 0 (fp32 log-sum-exp of
    the logits) plus 0.01 x the MoE aux loss — the reference's
    ``train_loss``."""
    logits, aux = forward(cfg, params, batch, mode="train", remat=remat,
                          compute_device=compute_device)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1)
    return nll + 0.01 * aux
