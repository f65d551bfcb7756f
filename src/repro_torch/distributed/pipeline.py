"""GPipe-style pipeline parallelism over ``torch.distributed`` — the port of
``repro/distributed/pipeline.py``.

The layer stack is split into S contiguous stages, stage s on the rank at
index s of mesh axis ``axis``.  M micro-batches stream through in
M + S − 1 ticks: at tick t stage s holds micro-batch t − s when that is in
[0, M), stage 0 injecting it from ``x``, the others taking what their left
neighbour sent one tick before; after every tick the stages that computed
hand their output one hop right (``comm.ppermute``; stage 0 receives
nothing).  The last stage retires micro-batch t − (S − 1) at tick t, and
its stack of outputs is broadcast to every rank at the end.  The fill and
drain are the S − 1 bubble ticks of GPipe's efficiency M / (M + S − 1).

A stage computes only the M ticks where it holds a live micro-batch; the
reference's ``shard_map`` body computes every tick and discards the bubble
ticks' results, so the outputs are the same.  :func:`unpipelined_reference`
is the oracle.
"""

from __future__ import annotations

import torch

from ..training.tree import leaves, tree_map
from . import comm


def pipeline_apply(mesh, stage_fn, stage_params, x: torch.Tensor, *,
                   n_micro: int, axis: str = "pipe") -> torch.Tensor:
    """Run ``stage_fn(stage_params, h) -> h`` (shape-preserving) over the
    S stages of ``axis``.  ``stage_params``: this rank's stage, what the
    reference's body sees after ``a[0]``; x: [M, mb, ...] micro-batched
    input, the same on every rank.  Returns [M, mb, ...] on every rank."""
    if x.shape[0] != n_micro:
        raise ValueError(f"x holds {x.shape[0]} micro-batches, not {n_micro}")
    n_stages = comm.axis_size(mesh, axis)
    stage = comm.axis_index(mesh, axis)
    acc = torch.zeros_like(x)
    inflight = torch.zeros_like(x[0])
    for t in range(n_micro + n_stages - 1):
        live = 0 <= t - stage < n_micro
        if live:
            h = stage_fn(stage_params, x[t] if stage == 0 else inflight)
            if stage == n_stages - 1:
                acc[t - stage] = h
        # stage i hands its output right when it held a micro-batch
        perm = [(i, i + 1) for i in range(n_stages - 1)
                if 0 <= t - i < n_micro]
        inflight = comm.ppermute(h if live else inflight, mesh, axis, perm)
    return comm.broadcast(acc, mesh, axis, src=n_stages - 1)


def unpipelined_reference(stage_fn, stacked_params, x: torch.Tensor):
    """The oracle: every stage applied in order to each micro-batch.
    ``stacked_params``: a tree whose leaves have the leading stage
    dimension S."""
    n_stages = leaves(stacked_params)[0].shape[0]

    def apply_all(h):
        for s in range(n_stages):
            h = stage_fn(tree_map(lambda a: a[s], stacked_params), h)
        return h
    return torch.stack([apply_all(x[m]) for m in range(x.shape[0])])
