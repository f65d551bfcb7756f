"""Latest-wins k-run merge of sorted (keys, seqs) runs on the compute device.

Within a single run keys are unique.  On duplicate keys the entry with the
highest seq survives: seqs are globally unique and increase over time, so
"latest wins" is "max seq wins", whatever the order the runs come in
(compactions pass them newest first, a scan's gather does not).  The runs
are reduced pairwise, oldest first, through the merge_path kernel wrapper
(``repro_torch.kernels.merge_path``) — the reference's ``_merge_pallas``
order — and each key's group then keeps its maximum seq, so the output
equals the numpy tier ``_merge_numpy`` (``lexsort`` by (key, seq), keep the
last) for any run order.
"""

from __future__ import annotations

import torch

from ..kernels.merge_path.ops import merge_two_runs


def merge_runs(runs: list[tuple[torch.Tensor, torch.Tensor]]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge k sorted (keys, seqs) runs; dedup latest-wins (max seq)."""
    dev = runs[0][0].device if runs else None
    runs = [r for r in runs if r[0].shape[0]]
    if not runs:
        z = torch.empty(0, dtype=torch.int64, device=dev)
        return z, z.clone()
    if len(runs) == 1:
        return runs[0]
    ordered = runs[::-1]  # oldest first
    acc_k, acc_s = ordered[0]
    for k, s in ordered[1:]:
        acc_k, acc_s = merge_two_runs(acc_k, acc_s, k, s)
    return dedup_latest(acc_k, acc_s)


def dedup_latest(keys: torch.Tensor, seqs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Given key-sorted arrays, keep each key once with its maximum seq."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(first, 0) - 1
    uniq = keys[first]
    best = torch.full_like(uniq, torch.iinfo(torch.int64).min)
    return uniq, best.scatter_reduce_(0, group, seqs, "amax")
