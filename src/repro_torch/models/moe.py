"""MLPs: SwiGLU / GELU dense blocks and the DeepSeek-V2-style MoE (shared
experts + top-k routed experts, capacity-bucket dispatch) — the port of
``repro/models/moe.py``.

Dispatch is the reference's sort-based formulation: assignments are ranked
within their expert by a stable argsort, scattered into per-expert capacity
buffers (an assignment past its expert's capacity goes to one extra drop
row, which is discarded), the experts run as batched products ``[E, C, d] x
[E, d, f]`` over their whole buffers (at decode too: the reference's
arithmetic), and the outputs are gathered back and combined with the
renormalised router weights, summed over k in fp32.  Dropped assignments
lose their routed contribution but keep the shared experts' path.  The
switch-style load-balance loss is returned beside the output.  The expert
products are plain ``torch.bmm``: the reference computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .common import dense_spec, materialize


# ---------------------------------------------------------------- dense MLP
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


# --------------------------------------------------------------------- MoE
def moe_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    p = {"router": dense_spec((d, e), dt, scale=0.02),
         "e_gate": dense_spec((e, d, f), dt),
         "e_up": dense_spec((e, d, f), dt),
         "e_down": dense_spec((e, f, d), dt)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["s_gate"] = dense_spec((d, fs), dt)
        p["s_up"] = dense_spec((d, fs), dt)
        p["s_down"] = dense_spec((fs, d), dt)
    return p


def init_moe(cfg, gen: torch.Generator) -> dict:
    return materialize(moe_specs(cfg), gen)


def moe_forward(cfg, p, x) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out, aux_loss).

    ``REPRO_MOE_GROUPS=G`` (read as the reference reads it): dispatch in G
    batch-aligned groups, each with its own capacity, and the mean of their
    aux losses; used only when G divides B."""
    b, s, d = x.shape
    groups = int(os.environ.get("REPRO_MOE_GROUPS", "1"))
    if groups > 1 and b % groups == 0:
        outs, auxs = zip(*(_moe_tokens(cfg, p, xg)
                           for xg in x.reshape(groups, -1, d)))
        return torch.stack(outs).reshape(b, s, d), torch.stack(auxs).mean()
    out, aux = _moe_tokens(cfg, p, x.reshape(b * s, d))
    return out.reshape(b, s, d), aux


def _moe_tokens(cfg, p, xt) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + compute + combine for a flat token block xt: [N, D]."""
    e, k = cfg.n_experts, cfg.top_k
    n, d = xt.shape
    dev = xt.device

    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)    # [N, E]
    # lax.top_k's order: descending, ties to the lower expert id
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]                # [N, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # the reference's capacity floor of 8 keeps a 1-token decode step
    # drop-free
    capacity = max(8, int(cfg.capacity_factor * n * k / e))

    # rank each assignment within its expert (stable: token order)
    flat_e = gate_idx.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(n * k, device=dev) - start[sorted_e]
    slot = torch.where(rank < capacity, flat_e * capacity + rank,
                       e * capacity)                             # drop row

    # scatter tokens into [E*C (+1 drop row), D] buffers
    tok_idx = torch.arange(n, device=dev).repeat_interleave(k)
    buffers = torch.zeros((e * capacity + 1, d), dtype=xt.dtype, device=dev)
    buffers.index_add_(0, slot, xt[tok_idx])
    buffers = buffers[:e * capacity].reshape(e, capacity, d)

    # batched expert MLPs  [E, C, d] x [E, d, f]
    hg = F.silu(torch.bmm(buffers, p["e_gate"]))
    hu = torch.bmm(buffers, p["e_up"])
    he = torch.bmm(hg * hu, p["e_down"])

    # gather back and combine with the gate weights
    he_flat = torch.cat([he.reshape(e * capacity, d),
                         torch.zeros((1, d), dtype=he.dtype, device=dev)])
    per_slot = he_flat[slot].reshape(n, k, d)
    out = torch.sum(per_slot.float() * gate_vals[..., None],
                    dim=1).to(xt.dtype)
    if cfg.n_shared_experts:
        out = out + (F.silu(xt @ p["s_gate"]) * (xt @ p["s_up"])) \
            @ p["s_down"]

    # switch-style load-balance loss
    frac_tokens = torch.bincount(flat_e, minlength=e).float() / (n * k) * k
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0)) / k
    return out, aux
