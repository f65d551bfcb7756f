"""Sorted-array rank: ``#{fence <= key}`` (side="right") or ``#{fence < key}``
(side="left") for every query key — the port of the overlap_scan TPU
kernel (``repro/kernels/overlap_scan/kernel.py``: ``_rank_kernel`` /
``fence_rank_call``).

:func:`fence_rank` is the wrapper every rank of the store goes through
outside the card's GET path: LevelIndex fence queries, vSST planning,
scans, the memtable probe and the plain GET chain.  On a CUDA tensor it
launches the kernel in ``csrc/overlap_scan.cu`` (one thread per key,
binary search over the fences in global memory); on a CPU tensor it runs
:func:`fence_rank_plain`.  The strict rank is computed directly
(no ``key - 1``, so INT64_MIN needs no special case) and there is no
fence padding (a key equal to INT64_MAX counts only real fences).

The card path is kept lean, since the store makes thousands of small calls
whose cost is the host's: the C entry is resolved once, the raw current
stream is read without building a ``torch.cuda.Stream``, and contiguous
inputs are passed as they are.

:func:`lookup_probe` is the GET path's fused probe: one launch of the
second entry of ``csrc/overlap_scan.cu`` walks every key of a GET batch
through the tree's runs (memtables, L0 SSTs, levels; :class:`ProbeRun`) in
the lookup's order, from one host-to-device copy of the keys packed with a
table of the runs (:func:`probe_table`).  :func:`lookup_probe_plain` is the
same walk as a chain of torch ops over all keys at once (:func:`plain_walk`):
the CPU path and the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build

_SIDES = {"right": 1, "left": 0}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
_launch = None        # the C entries, resolved at the first CUDA call
_probe_launch = None
_raw_stream = None    # torch._C._cuda_getCurrentRawStream

# Deterministic bloom-filter model: a (key, sst) pair pseudo-randomly false
# positives at the configured FPR.  The reference multiplies in uint64; the
# port multiplies in int64 with two's-complement wraparound, with each
# constant written as its int64 value, so the low 32 bits — and the float
# test against the FPR — are bit for bit the same.  The fused probe's
# kernel computes the same in uint64.
_KEY_MIX = 0x9E3779B97F4A7C15 - (1 << 64)
_MASK32 = 0xFFFFFFFF
_MAX32 = float(0xFFFFFFFF)

# The runs a GET walks, and the table the fused probe reads them from: one
# row of RUN_FIELDS int64 a run, ``(kind, keys, seqs, n, a, b, c, d)`` with
# the keys' and seqs' device addresses and their length, then for an L0
# SST ``a, b, c`` its smallest key, largest key and bloom seed, and for a
# level ``a, b, c`` the addresses of its smallest-key and largest-key fences
# and of its SSTs' bloom seeds and ``d`` its number of SSTs.
MEMTABLE, L0_SST, LEVEL = 0, 1, 2
RUN_FIELDS = 8


def bloom_false_positives(keys: torch.Tensor, bloom_seed,
                          fpr: float) -> torch.Tensor:
    """Boolean mask: which (key, sst) probes read a block despite a miss.

    ``bloom_seed`` is a scalar (one SST, many keys) or a tensor aligned
    with ``keys`` (one key per SST probe), int64 either way.
    """
    h = (keys * _KEY_MIX + bloom_seed) & _MASK32
    return (h.to(torch.float64) / _MAX32) < fpr


class ProbeRun(NamedTuple):
    """One run of the GET walk: sorted int64 ``keys`` and their encoded
    ``seqs`` (a memtable's deduplicated view, an L0 SST, a level's flat
    keys); for an L0 SST ``smallest``, ``largest`` and ``bloom`` are its
    fences and bloom seed (ints), for a level its fence arrays and its
    SSTs' bloom seeds (device tensors, one entry an SST)."""

    kind: int
    keys: torch.Tensor
    seqs: torch.Tensor
    smallest: int | torch.Tensor = 0
    largest: int | torch.Tensor = 0
    bloom: int | torch.Tensor = 0


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
    global _launch, _probe_launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("overlap_scan", "fence_rank_launch", _ARGTYPES)
    _probe_launch = _build.load("overlap_scan", "lookup_probe_launch",
                                _PROBE_ARGTYPES)


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


def _resolved(found: torch.Tensor, enc: torch.Tensor,
              seqs: torch.Tensor) -> None:
    """Write the logical seq (or -1 for a tombstone) of every found op."""
    seqs.copy_(torch.where(found, torch.where((enc & 1).to(torch.bool), -1,
                                              enc >> 1), seqs))


class WalkStep(NamedTuple):
    """One run of :func:`plain_walk`: the keys still unresolved when the
    walk reaches ``run`` (``active``), those whose search reads its keys
    (``cand``) and those it resolves (``found``), each key's clamped
    rank-left in its keys (``pos``) and the bloom seed of the SST each key
    is probed in (``seed``; 0 for a memtable)."""

    run: ProbeRun
    active: torch.Tensor
    cand: torch.Tensor
    found: torch.Tensor
    pos: torch.Tensor
    seed: int | torch.Tensor


def plain_walk(keys: torch.Tensor, runs: list[ProbeRun]):
    """The GET walk as torch ops over all keys at once: one
    :class:`WalkStep` a run, in order, every key carried under an
    ``active`` mask (no host reads), as a walk that stops at a key's first
    hit would reach each run."""
    active = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for run in runs:
        rk, seed = run.keys, 0
        if run.kind == MEMTABLE:
            cand = active
        elif run.kind == L0_SST:
            cand = active & (keys >= run.smallest) & (keys <= run.largest)
            seed = run.bloom
        else:   # one rank over the flat level finds the fence-selected SST
            n_ssts = int(run.smallest.shape[0])
            starts = fence_rank(run.largest, keys, "left")
            ends = fence_rank(run.smallest, keys, "right")
            cand = active & (ends > starts)
            seed = run.bloom[starts.clamp(max=n_ssts - 1)]
        pos = fence_rank(rk, keys, "left").clamp_(max=rk.shape[0] - 1)
        found = cand & (rk[pos] == keys)
        yield WalkStep(run, active, cand, found, pos, seed)
        active = active & ~found


def lookup_probe_plain(keys: torch.Tensor, runs: list[ProbeRun],
                       fpr: float) -> torch.Tensor:
    """The fused probe as a chain of torch ops (:func:`plain_walk`), which
    accounts exactly as a walk that stops at its first hit.  Returns
    ``[3, n]`` int64: the seq (-1 for a miss or a tombstone), the block
    reads and the SSTs probed of every key."""
    n = int(keys.shape[0])
    dev = keys.device
    seqs = torch.full((n,), -1, dtype=torch.int64, device=dev)
    reads = torch.zeros(n, dtype=torch.int32, device=dev)
    probed = torch.zeros(n, dtype=torch.int32, device=dev)
    for step in plain_walk(keys, runs):
        _resolved(step.found, step.run.seqs[step.pos], seqs)
        if step.run.kind == MEMTABLE:     # a hit is free: no probe, no read
            continue
        probed += step.cand
        reads += step.found     # bloom true positive -> one block read
        reads += step.cand & ~step.found & bloom_false_positives(
            keys, step.seed, fpr)
    return torch.stack([seqs, reads.to(torch.int64), probed.to(torch.int64)])


def probe_table(runs: list[ProbeRun]) -> np.ndarray:
    """The fused probe's run table, ``[len(runs), RUN_FIELDS]`` int64, built
    on the host from what it already knows (addresses, lengths, L0 fences
    and seeds): no device read."""
    table = np.zeros((len(runs), RUN_FIELDS), np.int64)
    for row, run in zip(table, runs):
        row[:4] = (run.kind, run.keys.data_ptr(), run.seqs.data_ptr(),
                   run.keys.shape[0])
        if run.kind == L0_SST:
            row[4:7] = (run.smallest, run.largest, run.bloom)
        elif run.kind == LEVEL:
            row[4:] = (run.smallest.data_ptr(), run.largest.data_ptr(),
                       run.bloom.data_ptr(), run.smallest.shape[0])
    return table


def lookup_probe(keys: np.ndarray, runs: list[ProbeRun], fpr: float,
                 device: torch.device) -> torch.Tensor:
    """Resolve a GET batch (host int64 ``keys``) against ``runs``, walked in
    order: ``[3, n]`` int64 on ``device`` as :func:`lookup_probe_plain`
    gives it.  On a CUDA device, one copy of the keys packed with the run
    table and one kernel launch; on the CPU, the plain chain."""
    keys = np.ascontiguousarray(keys, np.int64)
    if device.type == "cpu":
        return lookup_probe_plain(torch.from_numpy(keys), runs, fpr)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for run in runs:
        arrays = [run.keys, run.seqs]
        if run.kind == LEVEL:
            arrays += [run.smallest, run.largest, run.bloom]
        if not all(t.is_cuda and t.dtype is torch.int64 and t.is_contiguous()
                   for t in arrays):
            raise ValueError("lookup_probe takes contiguous int64 CUDA runs")
    n = int(keys.shape[0])
    out = torch.empty((3, n), dtype=torch.int64, device=device)
    if n == 0:
        return out
    packed = torch.from_numpy(
        np.concatenate([keys, probe_table(runs).ravel()])).to(device)
    if _probe_launch is None:
        _resolve()
    err = _probe_launch(packed.data_ptr(), n, len(runs), fpr, out.data_ptr(),
                        _raw_stream(packed.get_device()))
    if err:
        _build.check(err, "overlap_scan lookup_probe")
    lookup_probe.launches += 1
    return out


lookup_probe.launches = 0
