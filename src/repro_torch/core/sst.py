"""Sorted String Tables backed by int64 tensors on the compute device.

An SST is an immutable sorted run of (key, seq) pairs.  Values are implicit:
carrying the seqno is sufficient to verify latest-wins semantics.  Physical
size is ``n_keys * kv_size`` bytes.  The payload stays on the device; the
fences (``smallest``/``largest``) are host ints, read once at creation —
for a batch of SSTs cut from one merged run, in one transfer
(:func:`ssts_from_cuts`).
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager

import torch

from ..kernels.overlap_scan.ops import fence_rank

_ids = itertools.count()
# uid-allocator override stack: when a tree routes SST identity through its
# own counter (trees beyond fleet slot 0 — see LSMTree), the top of this
# stack replaces the module counter for SSTs created inside the scope.
_alloc_stack: list = []


@contextmanager
def uid_allocator(src):
    """Scope SST uid assignment to ``src`` (an iterator; None keeps the
    process-global counter)."""
    if src is None:
        yield
        return
    _alloc_stack.append(src)
    try:
        yield
    finally:
        _alloc_stack.pop()


class SST:
    __slots__ = ("keys", "seqs", "kv_size", "uid", "n", "size", "smallest",
                 "largest")

    def __init__(self, keys: torch.Tensor, seqs: torch.Tensor, kv_size: int,
                 bounds: tuple[int, int] | None = None,
                 uid: int | None = None):
        """``bounds`` = (first key, last key) when the caller already read
        them; ``uid`` pins the identity (state transfer) instead of drawing
        from the allocator."""
        assert keys.dim() == 1 and keys.shape == seqs.shape
        self.keys = keys
        self.seqs = seqs
        self.kv_size = kv_size
        if uid is None:
            uid = next(_alloc_stack[-1]) if _alloc_stack else next(_ids)
        self.uid = uid
        n = int(keys.shape[0])
        self.n = n
        self.size = n * kv_size
        if n == 0:
            self.smallest, self.largest = 0, -1   # empty range
        elif bounds is not None:
            self.smallest, self.largest = int(bounds[0]), int(bounds[1])
        else:
            self.smallest, self.largest = keys[[0, n - 1]].tolist()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SST#{self.uid}[{self.smallest}..{self.largest}] n={self.n}"

    # ----------------------------------------------------------------- query
    def get(self, key: int) -> int | None:
        """Return seqno for key or None."""
        probe = torch.tensor([key], dtype=torch.int64, device=self.keys.device)
        i = int(fence_rank(self.keys, probe, "left")[0])
        if i < self.n and int(self.keys[i]) == key:
            return int(self.seqs[i])
        return None

    def scan_from(self, key: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Up to ``m`` (keys, seqs) entries with key >= ``key``."""
        probe = torch.tensor([key], dtype=torch.int64, device=self.keys.device)
        i = int(fence_rank(self.keys, probe, "left")[0])
        return self.keys[i:i + m], self.seqs[i:i + m]

    def check_invariants(self) -> None:
        assert self.n > 0, "empty SST"
        assert bool((self.keys[1:] > self.keys[:-1]).all()), \
            "SST keys must be strictly increasing"
        assert [self.smallest, self.largest] == \
            self.keys[[0, self.n - 1]].tolist(), "SST fences out of sync"


def ssts_from_cuts(keys: torch.Tensor, seqs: torch.Tensor, kv_size: int,
                   starts: list[int], ends: list[int]) -> list[SST]:
    """SSTs over ``keys[starts[i]:ends[i]]`` (non-empty, in order), with all
    fences read in one device-to-host transfer."""
    if not starts:
        return []
    idx = torch.tensor(starts + [e - 1 for e in ends], dtype=torch.int64,
                       device=keys.device)
    fences = keys[idx].tolist()
    k = len(starts)
    return [SST(keys[a:b], seqs[a:b], kv_size, bounds=(fences[i], fences[k + i]))
            for i, (a, b) in enumerate(zip(starts, ends))]


def split_fixed(keys: torch.Tensor, seqs: torch.Tensor, kv_size: int,
                sst_size: int) -> list[SST]:
    """Split a sorted run into fixed-size SSTs of at most ``sst_size`` bytes."""
    per = max(1, sst_size // kv_size)
    n = int(keys.shape[0])
    starts = list(range(0, n, per))
    ends = [min(n, s + per) for s in starts]
    return ssts_from_cuts(keys, seqs, kv_size, starts, ends)


def total_size(ssts: list[SST]) -> int:
    return sum(s.size for s in ssts)


def overlapping(ssts: list[SST], lo: int, hi: int) -> list[SST]:
    """SSTs from a *sorted, disjoint* level whose range intersects [lo, hi]
    (the list-level oracle of ``LevelIndex.overlap_slice``)."""
    if not ssts:
        return []
    smallest = torch.tensor([s.smallest for s in ssts], dtype=torch.int64)
    largest = torch.tensor([s.largest for s in ssts], dtype=torch.int64)
    start = int(fence_rank(largest, torch.tensor([lo]), "left")[0])
    end = int(fence_rank(smallest, torch.tensor([hi]), "right")[0])
    return ssts[start:end]


def level_check_disjoint(ssts: list[SST]) -> None:
    """Invariant: leveled runs are sorted by key and pairwise disjoint."""
    for a, b in zip(ssts, ssts[1:]):
        assert a.largest < b.smallest, (
            f"overlapping leveled SSTs: {a} vs {b}")
