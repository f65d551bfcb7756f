"""Shared model components: norms, RoPE (incl. M-RoPE and per-layer theta),
sinusoidal positions, initializers — the port of ``repro/models/common.py``.

Initialisation draws from an explicit ``torch.Generator``; the reference's
``jax.random`` keys give other numbers from the same seed, so the parity
tests carry the reference's parameters across (``models/state.py``).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps,
                    plus_one=cfg.name.startswith("gemma"))


def norm_params(cfg, d: int) -> dict:
    """Leaf specs (see :func:`materialize`) of one norm's parameters."""
    dt = cfg.param_dtype
    if cfg.norm_type == "layernorm":
        return {"w": ("ones", (d,), dt), "b": ("zeros", (d,), dt)}
    init = "zeros" if cfg.name.startswith("gemma") else "ones"
    return {"w": (init, (d,), dt)}


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies (fp32)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [B, S, 3] for M-RoPE)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # [d/2]
    if mrope_sections:
        if positions.ndim != 3:
            raise ValueError("M-RoPE takes positions of shape [B, S, 3]")
        sec = np.cumsum((0,) + tuple(mrope_sections))
        if sec[-1] != d // 2:
            raise ValueError("mrope_sections must sum to head_dim / 2")
        sel = np.zeros(d // 2, np.int64)
        for i in range(len(mrope_sections)):
            sel[sec[i]:sec[i + 1]] = i
        pos = positions.float()[..., torch.from_numpy(sel).to(x.device)]
        ang = pos * inv[None, None, :]                         # [B,S,d/2]
    else:
        if positions.ndim == 3:
            positions = positions[..., 0]
        ang = positions.float()[:, :, None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                        # [B,S,1,d/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embedding [S, D]."""
    half = d // 2
    freqs = torch.exp(-np.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, std) in fp32, cast to ``dtype``; std is ``scale`` or
    fan_in ** -0.5 (fan_in = shape[-2], as in the reference).  Scaled in
    place: one fp32 temporary, not two (deepseek-v2-lite's stacked experts
    are 19.2 GB each in fp32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(std).to(dtype)


def dense_spec(shape, dtype: str, scale: float | None = None) -> tuple:
    """Leaf spec of a :func:`dense_init` parameter."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return ("normal", tuple(shape), dtype,
            scale if scale is not None else fan_in ** -0.5)


def stack_specs(specs: dict, n: int) -> dict:
    """Specs of ``n`` layers stacked on a leading axis (the reference's
    scan layout ``[L, ...]``); a normal leaf keeps its per-layer std."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = stack_specs(v, n)
        else:
            out[k] = (v[0], (n,) + tuple(v[1]), *v[2:])
    return out


def materialize(specs: dict, gen: torch.Generator) -> dict:
    """Parameters from leaf specs ``(kind, shape, dtype[, std])``, drawn from
    ``gen`` on its device in the specs' (insertion) order."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = materialize(v, gen)
            continue
        kind, shape, dt = v[0], v[1], DTYPES[v[2]]
        if kind == "normal":
            out[k] = dense_init(gen, shape, dt, scale=v[3])
        elif kind == "ones":
            out[k] = torch.ones(shape, dtype=dt, device=gen.device)
        else:
            out[k] = torch.zeros(shape, dtype=dt, device=gen.device)
    return out
