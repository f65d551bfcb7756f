"""Dense MLPs (SwiGLU / GELU) — the part of ``repro/models/moe.py`` the
ssm and hybrid families use.  The expert routing (``init_moe``,
``moe_forward``) waits for the MoE slice (ROADMAP)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_spec, materialize


def mlp_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = cfg.param_dtype
    if cfg.mlp_kind == "gelu":
        return {"w_up": dense_spec((d, f), dt), "b_up": ("zeros", (f,), dt),
                "w_down": dense_spec((f, d), dt),
                "b_down": ("zeros", (d,), dt)}
    return {"w_gate": dense_spec((d, f), dt), "w_up": dense_spec((d, f), dt),
            "w_down": dense_spec((f, d), dt)}


def init_mlp(cfg, gen: torch.Generator, d_ff: int | None = None) -> dict:
    return materialize(mlp_specs(cfg, d_ff), gen)


def mlp_forward(cfg, p, x) -> torch.Tensor:
    if "w_gate" in p:
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]
