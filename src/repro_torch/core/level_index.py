"""LevelIndex: the fence/bloom manifest shared by every overlap consumer.

Per level, the manifest mirrors the SST list in flat arrays (``smallest``,
``largest``, ``sizes``, ``uids``) and serves every overlap and rank query
from them, batched — GET fence selection, compaction scoring, scan spans
and vSST fences.  The arrays are maintained incrementally by the structural
mutators (flush appends to L0, splices, uid removals); queries never
rebuild anything.

Placement: the host keeps the small metadata arrays as numpy (the policies'
scalar control reads them), and every update pushes the level's fence and
bloom arrays to the compute device in one transfer (``dev_smallest``,
``dev_largest``, ``bloom``).  Every rank runs on the device through the
overlap_scan kernel wrapper; the SSTs of a sorted disjoint level
intersecting ``[lo, hi]`` are positions
``[rank_left(largest, lo), rank_right(smallest, hi))``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.overlap_scan.ops import fence_rank
from .sst import SST

# The bloom model (``bloom_false_positives``) lives beside the fused probe
# whose kernel computes it; an SST's seed is its uid times _UID_MIX, wrapped
# to int64 as the reference's uint64 product is.
_UID_MIX = 0xBF58476D1CE4E5B9 - (1 << 64)


def bloom_seed_for_uid(uid: int) -> int:
    """The bloom seed of one SST uid, as an int64 value."""
    seed = (int(uid) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    return seed - (1 << 64) if seed >= 1 << 63 else seed


def _as_device(vals, dev: torch.device) -> torch.Tensor:
    if isinstance(vals, torch.Tensor):
        return vals.to(dev)
    return torch.from_numpy(np.ascontiguousarray(vals, np.int64)).to(dev)


def _rank(arr: torch.Tensor, vals: torch.Tensor, side: str) -> torch.Tensor:
    """Rank of every value over a sorted int64 device fence array."""
    if arr.shape[0] == 0:
        return torch.zeros(vals.shape, dtype=torch.int64, device=vals.device)
    return fence_rank(arr, vals, side)


def _fields(ssts: list[SST]) -> tuple[np.ndarray, ...]:
    n = len(ssts)
    small = np.fromiter((s.smallest for s in ssts), np.int64, n)
    large = np.fromiter((s.largest for s in ssts), np.int64, n)
    sizes = np.fromiter((s.size for s in ssts), np.int64, n)
    uids = np.fromiter((s.uid for s in ssts), np.int64, n)
    return small, large, sizes, uids


class LevelIndex:
    """Flat fence/bloom arrays mirroring ``LSMTree.levels``.

    Position ``i`` in every array of ``level`` corresponds to
    ``levels[level][i]``; levels >= 1 are sorted by key and disjoint, L0 is
    FIFO (append order) and may overlap.
    """

    def __init__(self, n_levels: int, compute_device: torch.device):
        self.n_levels = n_levels
        self.compute_device = compute_device
        z = lambda: np.empty(0, np.int64)  # noqa: E731
        self.smallest = [z() for _ in range(n_levels)]
        self.largest = [z() for _ in range(n_levels)]
        self.sizes = [z() for _ in range(n_levels)]
        self.uids = [z() for _ in range(n_levels)]
        e = lambda: torch.empty(0, dtype=torch.int64,  # noqa: E731
                                device=compute_device)
        self.dev_smallest = [e() for _ in range(n_levels)]
        self.dev_largest = [e() for _ in range(n_levels)]
        self.bloom = [e() for _ in range(n_levels)]
        self._csum: list[np.ndarray | None] = [None] * n_levels
        # Per-level mutation counter: derived caches (the tree's flat
        # key/seq concatenation) invalidate lazily against it.
        self.version = [0] * n_levels

    # ------------------------------------------------ incremental updates
    def _set(self, level: int, small, large, sizes, uids) -> None:
        self.smallest[level] = small
        self.largest[level] = large
        self.sizes[level] = sizes
        self.uids[level] = uids
        dev = torch.from_numpy(np.stack([small, large, uids])).to(
            self.compute_device)
        self.dev_smallest[level] = dev[0]
        self.dev_largest[level] = dev[1]
        self.bloom[level] = dev[2] * _UID_MIX
        self._csum[level] = None
        self.version[level] += 1

    def refresh(self, level: int, ssts: list[SST]) -> None:
        """Bulk rebuild of one level's arrays (init / state transfer)."""
        self._set(level, *_fields(ssts))

    def l0_append(self, sst: SST) -> None:
        self._set(0,
                  np.append(self.smallest[0], sst.smallest),
                  np.append(self.largest[0], sst.largest),
                  np.append(self.sizes[0], sst.size),
                  np.append(self.uids[0], sst.uid))

    def l0_popleft(self) -> None:
        self._set(0, self.smallest[0][1:], self.largest[0][1:],
                  self.sizes[0][1:], self.uids[0][1:])

    def l0_clear(self) -> None:
        z = np.empty(0, np.int64)
        self._set(0, z, z.copy(), z.copy(), z.copy())

    def splice(self, level: int, start: int, end: int,
               new_ssts: list[SST]) -> None:
        """Replace positions [start, end) with ``new_ssts`` (sorted)."""
        small, large, sizes, uids = _fields(new_ssts)
        self._set(level,
                  np.concatenate([self.smallest[level][:start], small,
                                  self.smallest[level][end:]]),
                  np.concatenate([self.largest[level][:start], large,
                                  self.largest[level][end:]]),
                  np.concatenate([self.sizes[level][:start], sizes,
                                  self.sizes[level][end:]]),
                  np.concatenate([self.uids[level][:start], uids,
                                  self.uids[level][end:]]))

    def remove_uids(self, level: int, uids: list[int]) -> None:
        keep = ~np.isin(self.uids[level], np.asarray(uids, np.int64))
        self._set(level, self.smallest[level][keep], self.largest[level][keep],
                  self.sizes[level][keep], self.uids[level][keep])

    # ------------------------------------------------------------ queries
    def n_ssts(self, level: int) -> int:
        return int(self.uids[level].shape[0])

    def fences(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(smallest, largest) device fence arrays of a sorted, disjoint
        level."""
        return self.dev_smallest[level], self.dev_largest[level]

    def overlap_ranges(self, level: int, lo, hi
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-query device position slices [start, end) of the level's SSTs
        intersecting [lo_i, hi_i] (requires lo <= hi elementwise)."""
        lo = _as_device(lo, self.compute_device)
        hi = _as_device(hi, self.compute_device)
        starts = _rank(self.dev_largest[level], lo, "left")
        ends = _rank(self.dev_smallest[level], hi, "right")
        return starts, ends

    def overlap_slice(self, level: int, lo: int, hi: int) -> tuple[int, int]:
        s, e = self.overlap_ranges(level, np.asarray([lo], np.int64),
                                   np.asarray([hi], np.int64))
        start, end = torch.cat([s, e]).tolist()
        return start, end

    def overlap_counts(self, level: int, lo, hi) -> np.ndarray:
        """#SSTs of ``level`` intersecting each [lo_i, hi_i] (host array)."""
        starts, ends = self.overlap_ranges(level, lo, hi)
        return (ends - starts).clamp_(min=0).cpu().numpy()

    def scan_spans(self, level: int, start_keys: np.ndarray,
                   nbytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-scan SST position spans [start_i, end_i) of a sorted level
        covering a forward range scan: from the first SST whose range can
        contain ``start_keys[i]`` until the span holds >= ``nbytes[i]`` of
        data or the level ends (host arrays)."""
        dev = self.compute_device
        starts = _rank(self.dev_largest[level],
                       _as_device(start_keys, dev), "left")
        n = self.n_ssts(level)
        if n == 0:
            starts = starts.cpu().numpy()
            return starts, starts
        csum = torch.from_numpy(self.size_prefix(level)).to(dev)
        need = csum[starts.clamp(max=n)] + _as_device(nbytes, dev)
        ends = torch.maximum(fence_rank(csum, need, "left"), starts)
        return starts.cpu().numpy(), ends.clamp_(max=n).cpu().numpy()

    def size_prefix(self, level: int) -> np.ndarray:
        """csum[i] = total bytes of the level's first i SSTs (cached)."""
        if self._csum[level] is None:
            self._csum[level] = np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(self.sizes[level])])
        return self._csum[level]

    def overlap_bytes(self, src_level: int, dst_level: int) -> np.ndarray:
        """Per src-SST: bytes of dst_level SSTs its key range intersects —
        the compaction-picking score numerator, one batched query."""
        starts, ends = self.overlap_ranges(dst_level, self.smallest[src_level],
                                           self.largest[src_level])
        se = torch.stack([starts, ends]).cpu().numpy()
        csum = self.size_prefix(dst_level)
        return csum[se[1]] - csum[se[0]]

    # -------------------------------------------------------- validation
    def check_against(self, levels: list[list[SST]]) -> None:
        """Invariant: the mirror is in lock-step with the SST lists, on the
        host and on the device."""
        for level, ssts in enumerate(levels):
            small, large, sizes, uids = _fields(ssts)
            assert np.array_equal(self.smallest[level], small), \
                f"LevelIndex.smallest out of sync at L{level}"
            assert np.array_equal(self.largest[level], large), \
                f"LevelIndex.largest out of sync at L{level}"
            assert np.array_equal(self.sizes[level], sizes), \
                f"LevelIndex.sizes out of sync at L{level}"
            assert np.array_equal(self.uids[level], uids), \
                f"LevelIndex.uids out of sync at L{level}"
            dev = torch.stack([self.dev_smallest[level],
                               self.dev_largest[level]]).cpu().numpy()
            assert np.array_equal(dev[0], small) and \
                np.array_equal(dev[1], large), \
                f"LevelIndex device fences out of sync at L{level}"
