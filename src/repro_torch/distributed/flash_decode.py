"""Sequence-sharded decode attention ("flash decoding") over
``torch.distributed`` — the port of ``repro/distributed/flash_decode.py``.

Decode for archs whose KV heads do not divide the model axis keeps the
cache sequence-sharded (``sharding.cache_specs``).  Each rank of the axis
holds one slice of every sequence's cache, computes attention over it, and
the ranks combine their rows: the wire carries O(B·H·D), not the cache.

The reference combines (o, l, m) partials under ``shard_map``:

    m = pmax(m_loc);  l = psum(l_loc·e^(m_loc−m));
    o = psum(o_loc·e^(m_loc−m)) / l

Here each rank's partial is the paged_attention kernel's normalised
output and its rows' log-sum-exp, and the same combine reads

    M = pmax(lse);  w = e^(lse − M);  out = psum(w·o) / max(psum(w), 1e-30)

in fp32, cast to q's dtype (one ``psum`` carries w·o and w together).  A
rank with no live token of a sequence has lse −1e30 and weight 0.  On the
card the local partial is the kernel; on the CPU its plain version.

SPMD, one process a rank: each passes **its own slice** ``[B, T_loc, Hk,
D]`` where the reference passes the global cache and ``shard_map`` slices
it.  The slice is already a page pool of B pages of T_loc rows, so the
page table is ``[[0], [1], ...]`` and sequence b's length on rank r is
``clamp(pos[b] + 1 − r·T_loc, 0, T_loc)``: no copy.
"""

from __future__ import annotations

import torch

from ..kernels.paged_attention import paged_attention
from ..kernels.paged_attention.ops import NEG_INF
from . import comm


def _local_partial(q, k_loc, v_loc, t0: int, pos, scale: float):
    """(o, l, m) over a local cache slice, as the reference's: q [B, H, D];
    k_loc, v_loc [B, T_loc, Hk, D]; t0 the slice's first global token; pos
    [B].  fp32 o [B, Hk, G, D] (unnormalised), l and m [B, Hk, G]."""
    b, h, dh = q.shape
    hk = k_loc.shape[2]
    qg = q.reshape(b, hk, h // hk, dh).float()
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k_loc.float()) * scale
    t_idx = t0 + torch.arange(k_loc.shape[1], device=q.device)
    mask = (t_idx[None, :] <= pos.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)  # noqa: E741
    o = torch.einsum("bhgt,bthd->bhgd", p, v_loc.float())
    return o, l, m


def reference_decode_attn(q, k_cache, v_cache, pos, *,
                          scale: float | None = None):
    """The unsharded oracle: [B, H, D] in q's dtype."""
    b, h, dh = q.shape
    scale = scale if scale is not None else dh ** -0.5
    o, l, _ = _local_partial(q, k_cache, v_cache, 0, pos, scale)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, dh).to(q.dtype)


def seq_sharded_decode_attn(mesh, q, k_local, v_local, pos, *,
                            axis: str = "model", scale: float | None = None):
    """q: [B, H, D] (the same on every rank of ``axis``); k_local, v_local:
    this rank's [B, T_loc, Hk, D] slice, tokens [r·T_loc, (r+1)·T_loc) of
    the cache for the rank at index r; pos: [B] int, the last live token.
    Returns [B, H, D] in q's dtype, the same on every rank."""
    b, t_loc = k_local.shape[:2]
    t0 = comm.axis_index(mesh, axis) * t_loc
    page_table = torch.arange(b, dtype=torch.int32,
                              device=q.device)[:, None]
    lengths = torch.clamp(pos.to(q.device).long() + 1 - t0, 0,
                          t_loc).to(torch.int32)
    o, lse = paged_attention(q, k_local, v_local, page_table, lengths,
                             scale=scale, return_lse=True)
    return combine_partials(mesh, o, lse, axis=axis).to(q.dtype)


def combine_partials(mesh, o, lse, *, axis: str = "model"):
    """The ranks' normalised rows ``o`` [B, H, D] and their log-sum-exp
    ``lse`` [B, H] merged over ``axis``: fp32 [B, H, D], the same on every
    rank."""
    w = torch.exp(lse - comm.pmax(lse, mesh, axis))
    sums = comm.psum(torch.cat([w[..., None] * o.float(), w[..., None]],
                               dim=-1), mesh, axis)
    return sums[..., :-1] / torch.clamp(sums[..., -1:], min=1e-30)
