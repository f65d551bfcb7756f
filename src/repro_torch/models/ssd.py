"""Mamba2 block (SSD): init, full-sequence forward, single-step decode — the
port of ``repro/models/ssd.py``.

Block anatomy (Mamba2): in_proj -> [z | x | B | C | dt]; depthwise causal
conv over (x, B, C); SSD scan s_t = exp(dt A) s_{t-1} + dt B x^T, y = C s;
D-skip, SiLU(z) gating, RMSNorm, out_proj.

Both full-sequence routes follow the reference's default route
(``use_pallas=False``, the one its serve driver and ``train_loss`` take):
y comes from the ssd_scan kernel wrapper with fp32 dt, the softplus output
not rounded to x's dtype, as ``ssd_scan_ref`` receives it (the Pallas
route rounds it; in float32 the two agree).  :func:`ssd_prefill`, the
serving route, gives the block's output, conv tail and final state from
one input projection (the reference projects twice).  The final state,
which a prefill hands to decode, follows the reference's
``ssd_final_state``: fp32 dt and fp32 products of B and x.  The reference
runs a second, sequential scan over L for it; here the same call to
``ssd_scan`` computes it from ``state_dt`` (on the card a second chain
through the kernel's first two passes), so in bfloat16 too the state
agrees with the reference's to fp32 rounding.  :func:`ssd_forward`, the
training route, computes no final state (no ``state_dt``), as the
reference's training forward does not; its y is differentiable through
``ssd_scan``'s autograd Function, whose backward is the ssd_scan_bwd
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from .common import dense_spec, materialize, rms_norm


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def ssd_specs(cfg) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n_ = cfg.ssm_groups, cfg.ssm_state
    nh = cfg.ssm_heads
    dt = cfg.param_dtype
    in_dim = 2 * di + 2 * g * n_ + nh      # z, x, B, C, dt
    return {
        "in_proj": dense_spec((d, in_dim), dt),
        "conv_w": dense_spec((cfg.conv_kernel, conv_dim(cfg)), dt,
                             scale=cfg.conv_kernel ** -0.5),
        "conv_b": ("zeros", (conv_dim(cfg),), dt),
        "a_log": ("zeros", (nh,), "float32"),
        "dt_bias": ("zeros", (nh,), "float32"),
        "d_skip": ("ones", (nh,), "float32"),
        "ssm_norm": ("ones", (di,), dt),
        "out_proj": dense_spec((di, d), dt),
    }


def init_ssd(cfg, gen: torch.Generator) -> dict:
    return materialize(ssd_specs(cfg), gen)


def _split_proj(cfg, zxbcdt):
    di, nh = cfg.d_inner, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_dim(cfg)]
    dt = zxbcdt[..., di + conv_dim(cfg):di + conv_dim(cfg) + nh]
    return z, xbc, dt


def _silu(x):
    """SiLU as the reference's ``jax.nn.silu`` evaluates it,
    x * (1 / (1 + exp(-x))), each operation rounded to x's dtype: in
    bfloat16, ``F.silu``'s single rounding differs from it in ~40% of
    outputs (by one ulp).  Out of place, so autograd can take it."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


def _causal_conv(cfg, p, xbc):
    """Depthwise causal conv1d over [B, L, C], then SiLU."""
    k = cfg.conv_kernel
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i][None, None, :]
              for i in range(k))
    return _silu(out + p["conv_b"])


def ssd_prefill(cfg, p, h, *, want_state: bool = True):
    """The block over a full sequence from one projection and one scan
    call: (out [B, L, D], conv_tail [B, k-1, C], state [B, H, N, P] fp32,
    from fp32 dt as the reference's ``ssd_final_state``).  ``want_state``
    False is the training route, as the reference's training forward
    (``want_state=False``): the scan gets no ``state_dt``, so the kernel
    runs y's chain alone, and the state returned is that chain's."""
    b, L, _ = h.shape
    g, n_ = cfg.ssm_groups, cfg.ssm_state
    nh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt_raw = _split_proj(cfg, h @ p["in_proj"])
    xbc = _causal_conv(cfg, p, xbc_raw)
    x = xbc[..., :cfg.d_inner].reshape(b, L, nh, pd)
    bm = xbc[..., cfg.d_inner:cfg.d_inner + g * n_].reshape(b, L, g, n_)
    cm = xbc[..., cfg.d_inner + g * n_:].reshape(b, L, g, n_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, state = ssd_scan(x, dt, a, bm, cm,
                        state_dt=dt if want_state else None)
    y = y + x * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, L, cfg.d_inner)
    y = rms_norm(y * _silu(z), p["ssm_norm"], cfg.norm_eps)
    conv_tail = xbc_raw[:, -(cfg.conv_kernel - 1):, :]
    return y @ p["out_proj"], conv_tail, state


def ssd_forward(cfg, p, h):
    """Full-sequence forward, the training route (no final state):
    h: [B, L, D] -> ([B, L, D], conv_tail), differentiable through
    ``ssd_scan``'s backward kernel."""
    out, conv_tail, _state = ssd_prefill(cfg, p, h, want_state=False)
    return out, conv_tail


def ssd_final_state(cfg, p, h):
    """Final SSM state after a full sequence (for the prefill -> decode
    handoff).  Returns [B, H, N, P] fp32."""
    return ssd_prefill(cfg, p, h)[2]


def ssd_decode(cfg, p, h, conv_cache, state):
    """Single step.  h: [B, 1, D]; conv_cache: [B, k-1, conv_dim] (pre-conv
    features); state: [B, H, N, P] fp32.  Returns (out, conv_cache, state)."""
    b = h.shape[0]
    g, n_ = cfg.ssm_groups, cfg.ssm_state
    nh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt_raw = _split_proj(cfg, h @ p["in_proj"])   # [B,1,*]
    window = torch.cat([conv_cache, xbc_raw], dim=1)          # [B, k, C]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = _silu(conv_out)                                     # [B, C]
    x = xbc[..., :cfg.d_inner].reshape(b, nh, pd)
    bm = xbc[..., cfg.d_inner:cfg.d_inner + g * n_].reshape(b, g, n_)
    cm = xbc[..., cfg.d_inner + g * n_:].reshape(b, g, n_)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    rep = nh // g
    bf = bm.repeat_interleave(rep, dim=1)                     # [B, H, N]
    cf = cm.repeat_interleave(rep, dim=1)
    lam = torch.exp(dt * a[None, :])[..., None, None]         # [B, H, 1, 1]
    state = lam * state + dt[..., None, None] * (
        bf[..., :, None] * x[..., None, :].float())
    y = torch.einsum("bhn,bhnp->bhp", cf.float(), state)
    y = y.to(h.dtype) + x * p["d_skip"][None, :, None].to(h.dtype)
    y = y.reshape(b, 1, cfg.d_inner)
    y = rms_norm(y * _silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["out_proj"], window[:, 1:, :], state
