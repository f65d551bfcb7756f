"""Overlap-aware vSST splitting (paper §4.2) and good-vSST selection (§4.2.2).

During an L0→L1 compaction the merged key stream is cut into variable size
SSTs (vSSTs).  While a vSST grows, its overlap ``O`` — the number of
fixed-size L2 SSTs its key range intersects — is tracked against the growth
factor ``f``: a vSST reaches at least ``S_m = S_M / f`` bytes; at ``S_m``,
``O > f`` closes it as a **poor** vSST; otherwise keys are appended while
``O <= f`` up to ``S_M`` — a **good** vSST.  Selection ranks vSSTs by the
byte ratio ``overlap_bytes / size`` (§4.2.2).

The per-key overlap probe is two batched fence ranks over the whole merged
stream, computed on the device by the overlap_scan kernel wrapper and
copied to the host once per call; the plan walk then runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.overlap_scan.ops import fence_rank
from .sst import SST


@dataclass
class VSSTPlan:
    """A planned cut: keys[start:end] with its measured L2 overlap."""

    start: int
    end: int                # exclusive
    overlap_ssts: int       # number of L2 SSTs the range intersects
    good: bool

    def size(self, kv_size: int) -> int:
        return (self.end - self.start) * kv_size


def l2_fences(l2_ssts: list[SST], compute_device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(smallest, largest) device arrays of a sorted, disjoint L2."""
    lo = torch.tensor([s.smallest for s in l2_ssts], dtype=torch.int64)
    hi = torch.tensor([s.largest for s in l2_ssts], dtype=torch.int64)
    return lo.to(compute_device), hi.to(compute_device)


def overlap_count_range(fence_lo: torch.Tensor, fence_hi: torch.Tensor,
                        key_lo: int, key_hi: int) -> int:
    """Number of L2 SSTs whose key range intersects [key_lo, key_hi]."""
    if fence_lo.shape[0] == 0:
        return 0
    q = torch.tensor([key_lo, key_hi], dtype=torch.int64,
                     device=fence_lo.device)
    first = fence_rank(fence_hi, q[:1], "left")
    last = fence_rank(fence_lo, q[1:], "right")
    return max(0, int(last - first))


def _ranks(keys: torch.Tensor, fence_lo: torch.Tensor,
           fence_hi: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Host copies of ``R = #{fence_lo <= key}`` and ``Lh = #{fence_hi <
    key}`` for every key, in one transfer."""
    n = int(keys.shape[0])
    if fence_lo.shape[0] == 0:
        return np.zeros(n, np.int64), np.zeros(n, np.int64)
    both = torch.stack([fence_rank(fence_lo, keys, "right"),
                        fence_rank(fence_hi, keys, "left")]).cpu().numpy()
    return both[0], both[1]


def plan_vssts(keys: torch.Tensor, kv_size: int, s_m: int, s_M: int, f: int,
               fence_lo: torch.Tensor, fence_hi: torch.Tensor,
               sst_size_l2: int) -> list[VSSTPlan]:
    """Cut a merged sorted key stream into vSST plans per the §4.2 heuristic.

    Two batched fence ranks over the whole stream — ``R[j] = #{fence_lo <=
    keys[j]}`` and ``Lh[i] = #{fence_hi < keys[i]}`` — give the overlap of
    any cut as ``max(0, R[j-1] - Lh[i])``; ``R`` is nondecreasing, so the
    "extend while overlap <= f" rule is one host search per crossing.
    """
    del sst_size_l2  # good/poor is count-based; byte size only matters at selection
    n = int(keys.shape[0])
    if n == 0:
        return []
    min_keys = max(1, s_m // kv_size)
    max_keys = max(min_keys, s_M // kv_size)
    r_arr, lh_arr = _ranks(keys, fence_lo, fence_hi)

    def _ov(i: int, j: int) -> int:
        # L2 SSTs intersected by [keys[i], keys[j-1]]
        return max(0, int(r_arr[j - 1]) - int(lh_arr[i]))

    plans: list[VSSTPlan] = []
    i = 0
    while i < n:
        hard_end = min(n, i + max_keys)
        j_min = min(n, i + min_keys)
        ov_min = _ov(i, j_min)
        if ov_min > f:
            # Poor vSST: close at S_m (paper: "their size is always S_m").
            plans.append(VSSTPlan(i, j_min, ov_min, good=False))
            i = j_min
            continue
        # Good vSST: crossing-by-crossing replay of the segment walk over
        # the precomputed ranks; the walk absorbs the remainder of the
        # fence segment containing j before re-checking f.
        j = j_min
        while j < hard_end:
            j = min(hard_end,
                    int(np.searchsorted(r_arr, r_arr[j], side="right")))
            if j >= hard_end or int(r_arr[j]) - int(lh_arr[i]) > f:
                break
            j += 1
        ov = _ov(i, j)
        plans.append(VSSTPlan(i, j, ov, good=ov <= f))
        i = j
    # Absorb a too-small trailing plan into its predecessor.
    if len(plans) >= 2 and (plans[-1].end - plans[-1].start) < min_keys:
        tail = plans.pop()
        prev = plans.pop()
        ov = _ov(prev.start, tail.end)
        plans.append(VSSTPlan(prev.start, tail.end, ov, good=ov <= f))
    return plans


def select_good_vssts(l1_ssts: list[SST], fence_lo: torch.Tensor,
                      fence_hi: torch.Tensor, sst_size_l2: int, f: int,
                      bytes_needed: int, ov: np.ndarray | None = None
                      ) -> list[int]:
    """§4.2.2: RocksDB's ratio scheduler over vSSTs.

    Ranks every L1 vSST by ``overlap_bytes_in_L2 / size`` ascending, keeps
    only *good* candidates (L2-SST count ``<= f``), and picks until the
    cumulative size frees ``bytes_needed``.  Returns indices into
    ``l1_ssts``.  ``ov`` — per-vSST L2 overlap counts (host) — may be
    supplied precomputed; otherwise it is ranked here on the device.
    """
    if not l1_ssts:
        return []
    n = len(l1_ssts)
    sizes = np.fromiter((s.size for s in l1_ssts), np.int64, n)
    if ov is None:
        if fence_lo.shape[0]:
            dev = fence_lo.device
            s_lo = torch.tensor([s.smallest for s in l1_ssts],
                                dtype=torch.int64).to(dev)
            s_hi = torch.tensor([s.largest for s in l1_ssts],
                                dtype=torch.int64).to(dev)
            first = fence_rank(fence_hi, s_lo, "left")
            last = fence_rank(fence_lo, s_hi, "right")
            ov = (last - first).clamp_(min=0).cpu().numpy()
        else:
            ov = np.zeros(n, np.int64)
    ratio = ov * np.int64(sst_size_l2) / np.maximum(1, sizes)
    order = np.lexsort((np.arange(n), -sizes, ratio))
    picked, freed = [], 0
    for idx in order:
        if ov[idx] > f:        # poor vSST: never picked by the scheduler
            continue
        idx = int(idx)
        picked.append(idx)
        freed += int(sizes[idx])
        if freed >= bytes_needed:
            break
    return picked
