"""Sorted-array rank: ``#{fence <= key}`` (side="right") or ``#{fence < key}``
(side="left") for every query key — the port of the overlap_scan TPU
kernel (``repro/kernels/overlap_scan/kernel.py``: ``_rank_kernel`` /
``fence_rank_call``).

:func:`fence_rank` is the wrapper every rank of the store goes through:
LevelIndex fence queries, vSST planning, the flat-level and per-SST GET
probes and the memtable probe.  On a CUDA tensor it launches the kernel in
``csrc/overlap_scan.cu`` (one thread per key, binary search over the
fences in global memory); on a CPU tensor it runs
:func:`fence_rank_plain`.  The strict rank is computed directly
(no ``key - 1``, so INT64_MIN needs no special case) and there is no
fence padding (a key equal to INT64_MAX counts only real fences).

The card path is kept lean, since the store makes thousands of small calls
whose cost is the host's: the C entry is resolved once, the raw current
stream is read without building a ``torch.cuda.Stream``, and contiguous
inputs are passed as they are.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_SIDES = {"right": 1, "left": 0}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_launch = None       # the C entry, resolved at the first CUDA call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


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


def _resolve() -> None:
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("overlap_scan", "fence_rank_launch", _ARGTYPES)


def fence_rank(fences: torch.Tensor, keys: torch.Tensor,
               side: str = "right") -> torch.Tensor:
    """int64 rank of every key of ``keys`` (any shape) over the sorted int64
    ``fences``: ``searchsorted(fences, keys, side)``."""
    right = _SIDES.get(side) if isinstance(side, str) else None
    if right is None:
        raise ValueError(f"side must be 'right' or 'left', not {side!r}")
    if fences.dtype is not torch.int64 or keys.dtype is not torch.int64:
        raise TypeError("fence_rank takes int64 fences and keys")
    if not keys.is_cuda:
        if fences.device != keys.device:
            raise ValueError("fences and keys must be on one device")
        if keys.device.type != "cpu":
            raise ValueError(f"unsupported device {keys.device}")
        return fence_rank_plain(fences, keys, side)
    dev = keys.get_device()
    if fences.get_device() != dev:
        raise ValueError("fences and keys must be on one device")
    if not keys.is_contiguous():
        keys = keys.contiguous()
    if not fences.is_contiguous():
        fences = fences.contiguous()
    out = torch.empty_like(keys)
    m = out.numel()
    if m == 0:
        return out
    if _launch is None:
        _resolve()
    err = _launch(fences.data_ptr(), fences.shape[0], keys.data_ptr(), m,
                  out.data_ptr(), right, _raw_stream(dev))
    if err:
        _build.check(err, "overlap_scan")
    fence_rank.launches += 1
    return out


fence_rank.launches = 0
