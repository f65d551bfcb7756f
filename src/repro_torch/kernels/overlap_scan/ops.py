"""Sorted-array rank: ``#{fence <= key}`` (side="right") or ``#{fence < key}``
(side="left") for every query key — the port of the overlap_scan TPU
kernel (``repro/kernels/overlap_scan/kernel.py``: ``_rank_kernel`` /
``fence_rank_call``).

:func:`fence_rank` is the wrapper every rank of the store goes through:
LevelIndex fence queries, vSST planning, the flat-level and per-SST GET
probes and the memtable probe.  On a CUDA tensor it launches the kernel in
``csrc/overlap_scan.cu`` (one thread per key, binary search over the
fences); on a CPU tensor it runs :func:`fence_rank_plain`.  The strict rank
is computed directly (no ``key - 1``, so INT64_MIN needs no special case)
and there is no fence padding (a key equal to INT64_MAX counts only real
fences).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_SIDES = {"right": 1, "left": 0}


def fence_rank_plain(fences: torch.Tensor, keys: torch.Tensor,
                     side: str = "right") -> torch.Tensor:
    """Vectorized binary search in torch: ``ceil(log2(n + 1))`` halving
    steps over all keys at once, O(m log n)."""
    n = int(fences.shape[0])
    lo = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    if n == 0:
        return lo
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = fences[mid.clamp(max=n - 1)]
        below = (v <= keys) if side == "right" else (v < keys)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def fence_rank(fences: torch.Tensor, keys: torch.Tensor,
               side: str = "right") -> torch.Tensor:
    """int64 rank of every key of ``keys`` (any shape) over the sorted int64
    ``fences``: ``searchsorted(fences, keys, side)``."""
    if side not in _SIDES:
        raise ValueError(f"side must be 'right' or 'left', not {side!r}")
    if fences.dtype != torch.int64 or keys.dtype != torch.int64:
        raise TypeError("fence_rank takes int64 fences and keys")
    if fences.device != keys.device:
        raise ValueError("fences and keys must be on one device")
    if keys.device.type == "cpu":
        return fence_rank_plain(fences, keys, side)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    fences = fences.contiguous()
    flat = keys.contiguous().view(-1)
    out = torch.empty_like(flat)
    if flat.shape[0] == 0:
        return out.view(keys.shape)
    fn = _build.load("overlap_scan", "fence_rank_launch",
                     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    err = fn(fences.data_ptr(), fences.shape[0], flat.data_ptr(),
             flat.shape[0], out.data_ptr(), _SIDES[side],
             torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "overlap_scan")
    fence_rank.launches += 1
    return out.view(keys.shape)


fence_rank.launches = 0
