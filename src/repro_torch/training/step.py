"""train_step / serve_step factories — the port of
``repro/training/step.py``.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradient by autograd through the
port's forward (every attention's gradient the flash_attention_bwd
kernel; each stacked layer rematerialised when ``remat``), optional
gradient accumulation over micro-batches, with ``compress_grads`` the
gradients' int8 quantization with error feedback
(``distributed.compression.compress_tree``, its residual carried across
steps in ``opt_state["ef"]``), then AdamW with clipping (parameters and
moments updated in place).  It runs eagerly: the
reference jits it.  ``make_serve_step`` returns the single-token decode,
``make_prefill`` the full-sequence prefill.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.types import resolve_compute_device
from ..distributed.compression import compress_tree
from ..models import decode_step, forward, train_loss
from .optimizer import AdamWConfig, adamw_update
from .tree import leaves, tree_map, unflatten_like


def value_and_grad(cfg, params: dict, batch: dict, *, remat: bool = True,
                   compute_device: str | torch.device = "cuda"):
    """(loss, grads): ``train_loss`` and its gradient with respect to every
    parameter (grads in the parameters' dtypes and structure)."""
    flat = leaves(params)
    req = [p.detach().requires_grad_(True) for p in flat]
    loss = train_loss(cfg, unflatten_like(params, req), batch, remat=remat,
                      compute_device=compute_device)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten_like(params, grads)


def _micro(batch: dict, i: int, n: int) -> dict:
    out = {}
    for k, x in batch.items():
        mb = x.shape[0] // n
        out[k] = x[i * mb:(i + 1) * mb]
    return out


def make_train_step(cfg, opt_cfg: AdamWConfig | None = None, *,
                    remat: bool = True, grad_accum: int = 1,
                    compress_grads: bool = False,
                    compute_device: str | torch.device = "cuda"):
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_compute_device(compute_device)

    def step(params, opt_state, batch):
        if grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                mloss, mgrads = value_and_grad(
                    cfg, params, _micro(batch, i, grad_accum), remat=remat,
                    compute_device=dev)
                loss = loss + mloss
                grads = tree_map(torch.add, grads, mgrads)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, grads = value_and_grad(cfg, params, batch, remat=remat,
                                         compute_device=dev)
        if compress_grads:
            grads, opt_state = compress_tree(grads, opt_state)
        params, opt_state, gnorm = adamw_update(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_serve_step(cfg, *, absorbed_mla: bool = True,
                    compute_device: str | torch.device = "cuda"):
    def serve_step(params, tokens, pos, cache):
        logits, cache = decode_step(cfg, params, tokens, pos, cache,
                                    absorbed_mla=absorbed_mla,
                                    compute_device=compute_device)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return serve_step


def make_prefill(cfg, *, cache_len: int | None = None,
                 compute_device: str | torch.device = "cuda"):
    def prefill(params, batch) -> Any:
        return forward(cfg, params, batch, mode="prefill",
                       cache_len=cache_len, remat=False,
                       compute_device=compute_device)
    return prefill
