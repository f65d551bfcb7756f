"""Batched FIFO-queue departure times (the exact Lindley recursion) — the
port of the lindley_scan TPU kernel (``repro/kernels/lindley_scan/
kernel.py``: ``_lindley_kernel`` / ``lindley_scan_call``).

For each queue (row) with per-op service ``s`` and arrivals ``a``::

    D_j = S_j + max(d0, max_{k<=j}(a_k - S_{k-1})),   S_j = cumsum(s)_j

in float64 (absolute simulated times of hundreds of seconds against
microsecond latencies leave float32 no bits in the tail).

The batch is ragged, in CSR layout: one flat service buffer, one flat
arrival buffer, host row ``offsets`` (B + 1 entries) and a ``d0`` per row
(default -inf: a queue observed from its first arrival).  This replaces the
reference's power-of-two pad buckets, which existed for the TPU's fixed
shapes.  On CUDA tensors :func:`lindley_batch` launches
``csrc/lindley_scan.cu``; on CPU tensors it runs :func:`lindley_batch_plain`,
which repeats ``lindley_numpy``'s operation order row by row and so agrees
with the reference's numpy pass bit for bit.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from .. import _build

TILE = 1024          # elements per block of the kernel's tile passes


def _rows(offsets, d0, n_total: int) -> tuple[np.ndarray, np.ndarray]:
    off = np.asarray(offsets, np.int64)
    b = off.shape[0] - 1
    if b < 0 or off[0] != 0 or off[-1] != n_total or np.any(np.diff(off) < 0):
        raise ValueError("offsets must rise from 0 to the buffer length")
    d = np.full(b, -np.inf) if d0 is None else np.asarray(d0, np.float64)
    if d.shape != (b,):
        raise ValueError("d0 needs one value per row")
    return off, d


def lindley_batch_plain(service: torch.Tensor, arrivals: torch.Tensor,
                        offsets: Sequence[int],
                        d0: Sequence[float] | None = None) -> torch.Tensor:
    """Row-by-row recursion in ``lindley_numpy``'s operation order."""
    off, d = _rows(offsets, d0, int(service.shape[0]))
    out = torch.empty_like(service)
    for r in range(off.shape[0] - 1):
        a, b = int(off[r]), int(off[r + 1])
        if a == b:
            continue
        s_cum = torch.cumsum(service[a:b], 0)
        base = arrivals[a:b].clone()
        base[1:] -= s_cum[:-1]
        base = torch.clamp(base, min=float(d[r]))
        out[a:b] = s_cum + torch.cummax(base, 0).values
    return out


def lindley_batch(service: torch.Tensor, arrivals: torch.Tensor,
                  offsets: Sequence[int],
                  d0: Sequence[float] | None = None) -> torch.Tensor:
    """Departure times of every op of a ragged batch of FIFO queues."""
    if service.dtype != torch.float64 or arrivals.dtype != torch.float64:
        raise TypeError("lindley_batch takes float64 service and arrivals")
    if service.dim() != 1 or service.shape != arrivals.shape:
        raise ValueError("service and arrivals must be 1-D of one length")
    if service.device != arrivals.device:
        raise ValueError("service and arrivals must be on one device")
    dev = service.device
    if dev.type == "cpu":
        return lindley_batch_plain(service, arrivals, offsets, d0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    off, d = _rows(offsets, d0, int(service.shape[0]))
    n_rows = off.shape[0] - 1
    tiles = -(-np.diff(off) // TILE)
    tile_first = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    n_tiles = int(tile_first[-1])
    out = torch.empty_like(service)
    if n_tiles == 0:
        return out
    service, arrivals = service.contiguous(), arrivals.contiguous()
    meta = torch.from_numpy(np.concatenate([off, tile_first])).to(dev)
    d0_dev = torch.from_numpy(d).to(dev)
    tile_agg = torch.empty((n_tiles, 2), dtype=torch.float64, device=dev)
    tile_carry = torch.empty_like(tile_agg)
    fn = _build.load("lindley_scan", "lindley_scan_launch",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p])
    err = fn(service.data_ptr(), arrivals.data_ptr(), meta.data_ptr(),
             meta.data_ptr() + 8 * (n_rows + 1), d0_dev.data_ptr(), n_rows,
             n_tiles, tile_agg.data_ptr(), tile_carry.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lindley_scan")
    lindley_batch.launches += 1
    return out


lindley_batch.launches = 0
