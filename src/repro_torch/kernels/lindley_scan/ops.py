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
``csrc/lindley_scan.cu`` (one streaming pass over 4,096-op tiles whose
carries are summed in a fixed order, so two calls give the same bits); on
CPU tensors it runs :func:`lindley_batch_plain`, which repeats
``lindley_numpy``'s operation order row by row and so agrees with the
reference's numpy pass bit for bit.

The card path is lean: the C entry is resolved once, the raw current stream
is read without building a ``torch.cuda.Stream``, one row travels as
scalars, and a ragged batch's plan (offsets, d0 and each tile's row) in one
pinned, non-blocking copy; nothing synchronises with the host.  Inputs are
not checked for NaN (that would need a sync): the kernel's running max
skips a NaN where the plain version's spreads it, so NaN inputs give other
departures on the card, but every call ends.

:func:`lindley_batch_np` is the list-of-queues front end the fleet engine
and the sweeps call (the reference's ``lindley_batch_np``): numpy queues in,
numpy departures out, through one CSR buffer and one :func:`lindley_batch`
call.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Sequence

import numpy as np
import torch

from .. import _build

TILE = 4096          # ops of a tile: the kernel's kTile, checked at load


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


def plan(offsets, d0, n_total: int) -> tuple[np.ndarray | None, int, float]:
    """The kernel's tile plan of a batch: (int64 plan, tiles, d0 of a
    single row).  The plan is ``[offsets | first tile of each row (B + 1) |
    d0 as float64 bits | row of each tile]``; for one row it is None and
    the row travels as scalars (its length and d0)."""
    if len(offsets) == 2 and (d0 is None or len(d0) == 1):
        if int(offsets[0]) != 0 or int(offsets[1]) != n_total:
            raise ValueError("offsets must rise from 0 to the buffer length")
        return (None, -(-n_total // TILE),
                -math.inf if d0 is None else float(d0[0]))
    off, d = _rows(offsets, d0, n_total)
    per_row = -(-np.diff(off) // TILE)
    first = np.zeros(off.shape[0], np.int64)
    np.cumsum(per_row, out=first[1:])
    rows = np.repeat(np.arange(off.shape[0] - 1), per_row)
    packed = np.concatenate([off, first, d.view(np.int64), rows])
    return packed, int(first[-1]), -math.inf


# per (device, stream): the kernel's tile counter and carries (16 + 32
# bytes a tile), reset by each call; reused only on its own stream, where
# calls run one after another
_scratch: dict[tuple[int, int], torch.Tensor] = {}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_launch = None       # the C entry, resolved at the first CUDA call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


def _resolve() -> None:
    global _launch, _raw_stream
    tile = _build.load("lindley_scan", "lindley_scan_tile", [])()
    if tile != TILE:
        raise RuntimeError(f"lindley_scan: the library's tile is {tile}, "
                           f"ops.TILE {TILE}")
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("lindley_scan", "lindley_scan_launch", _ARGTYPES)


def lindley_batch(service: torch.Tensor, arrivals: torch.Tensor,
                  offsets: Sequence[int],
                  d0: Sequence[float] | None = None) -> torch.Tensor:
    """Departure times of every op of a ragged batch of FIFO queues.  On
    the card two calls on the same inputs give the same bits."""
    if service.dtype is not torch.float64 \
            or arrivals.dtype is not torch.float64:
        raise TypeError("lindley_batch takes float64 service and arrivals")
    if service.dim() != 1 or service.shape != arrivals.shape:
        raise ValueError("service and arrivals must be 1-D of one length")
    if not service.is_cuda:
        if service.device != arrivals.device:
            raise ValueError("service and arrivals must be on one device")
        if service.device.type != "cpu":
            raise ValueError(f"unsupported device {service.device}")
        return lindley_batch_plain(service, arrivals, offsets, d0)
    dev = service.get_device()
    if arrivals.get_device() != dev:
        raise ValueError("service and arrivals must be on one device")
    n = service.shape[0]
    packed, tiles, d0v = plan(offsets, d0, n)
    out = torch.empty_like(service)
    if tiles == 0:
        return out
    if not service.is_contiguous():
        service = service.contiguous()
    if not arrivals.is_contiguous():
        arrivals = arrivals.contiguous()
    if _launch is None:
        _resolve()
    stream = _raw_stream(dev)
    on_card = None
    if packed is not None:
        host = torch.from_numpy(packed).pin_memory()
        on_card = host.to(service.device, non_blocking=True)
    scratch = _scratch.get((dev, stream))
    if scratch is None or scratch.numel() < 2 + 4 * tiles:
        scratch = _scratch[dev, stream] = torch.empty(
            2 + 4 * tiles, dtype=torch.int64, device=service.device)
    err = _launch(service.data_ptr(), arrivals.data_ptr(),
                  None if on_card is None else on_card.data_ptr(),
                  len(offsets) - 1, tiles, n, d0v, scratch.data_ptr(),
                  out.data_ptr(), stream)
    if err:
        _build.check(err, "lindley_scan")
    lindley_batch.launches += 1
    return out


lindley_batch.launches = 0


def lindley_batch_np(services: Sequence[np.ndarray],
                     arrivals: Sequence[np.ndarray],
                     d0: Sequence[float] | None = None,
                     compute_device: str | torch.device = "cuda"
                     ) -> list[np.ndarray]:
    """Departure times of a list of FIFO queues (the reference's
    ``lindley_batch_np``): ``services[i]`` and ``arrivals[i]`` are queue
    i's per-op service and arrival times (1-D, equal length, possibly
    empty), ``d0[i]`` its carried-in clock (default -inf).  Returns one
    float64 array per queue.

    The queues become ONE CSR buffer on ``compute_device`` and go through
    ONE :func:`lindley_batch` call: on the card one kernel launch for the
    whole list, however ragged; on the CPU the plain version, in
    ``lindley_numpy``'s operation order row by row.  The reference pads
    the queues into power-of-two buckets with a cached pad plan because
    the TPU kernel takes rectangular blocks; the Hopper kernel takes
    ragged rows, so there is no pad plan and no plan cache here."""
    dev = torch.device(compute_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "compute_device='cuda' but torch sees no CUDA device; pass "
            "compute_device='cpu' to run the plain PyTorch tier")
    b = len(services)
    if len(arrivals) != b:
        raise ValueError("one arrival array per service array")
    lens = np.fromiter((s.shape[0] for s in services), np.int64, b)
    offsets = np.zeros(b + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    if total == 0:
        return [np.empty(0, np.float64) for _ in range(b)]
    host = np.empty((2, total), np.float64)
    np.concatenate(services, out=host[0], casting="same_kind")
    np.concatenate(arrivals, out=host[1], casting="same_kind")
    queues = torch.from_numpy(host).to(dev)
    dep = lindley_batch(queues[0], queues[1], offsets, d0).cpu().numpy()
    return np.split(dep, offsets[1:-1])
