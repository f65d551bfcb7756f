"""AdamW with fp32 moments — the port of ``repro/training/optimizer.py``,
the same arithmetic in the same order.

Moments are fp32 whatever the parameters' dtype.  :func:`adamw_update`
updates the parameters and both moments in place (the reference returns
new arrays): at qwen3-1.7b's full size that keeps one copy of the 3.4 GB of
bf16 weights and of the 13.8 GB of moments.  Each new parameter is computed
in fp32 and cast back to its dtype, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: dict) -> dict:
    """fp32 zero moments ``m`` and ``v`` of the parameters' structure and an
    int32 ``step``, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves in the
    reference's (sorted-key) order."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step with global-norm clipping.  Updates ``params``,
    ``state["m"]`` and ``state["v"]`` in place and returns (params, state,
    grad_norm) with ``state["step"]`` advanced."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    c1 = 1 - torch.pow(cfg.b1, stepf)
    c2 = 1 - torch.pow(cfg.b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        delta += cfg.weight_decay * p.float()
        p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, gnorm
