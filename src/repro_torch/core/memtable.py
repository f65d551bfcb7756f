"""Write buffer (memtable) on the compute device.

PUTs append into growing device chunks; at flush time the buffer is sorted
with a stable sort and deduplicated latest-wins — equivalent to a skiplist
memtable's iterator, but vectorized.  Memtable probes are free CPU work in
the cost model, as in the paper: memtable hits never touch the storage
device.
"""

from __future__ import annotations

import torch

from ..kernels.overlap_scan.ops import fence_rank
from .sst import SST


class Memtable:
    def __init__(self, capacity_bytes: int, kv_size: int,
                 compute_device: torch.device):
        self.capacity = capacity_bytes
        self.kv_size = kv_size
        self.compute_device = compute_device
        self._keys: list[torch.Tensor] = []
        self._seqs: list[torch.Tensor] = []
        self._n = 0
        self._sorted: tuple[torch.Tensor, torch.Tensor] | None = None

    @property
    def n(self) -> int:
        return self._n

    @property
    def size(self) -> int:
        return self._n * self.kv_size

    @property
    def full(self) -> bool:
        return self.size >= self.capacity

    @property
    def room(self) -> int:
        """Number of puts that fit before the memtable is full."""
        return max(0, (self.capacity - self.size) // self.kv_size)

    def put_batch(self, keys: torch.Tensor, seqs: torch.Tensor) -> None:
        assert keys.shape == seqs.shape
        self._keys.append(keys)
        self._seqs.append(seqs)
        self._n += int(keys.shape[0])
        self._sorted = None

    def get(self, key: int) -> int | None:
        got = int(self.get_batch(torch.tensor(
            [key], dtype=torch.int64, device=self.compute_device))[0])
        return None if got < 0 else got

    def to_sorted(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Sorted, latest-wins-deduplicated contents (cached until the next
        put; callers must not mutate the returned tensors)."""
        if self._sorted is not None:
            return self._sorted
        if not self._keys:
            z = torch.empty(0, dtype=torch.int64, device=self.compute_device)
            self._sorted = (z, z.clone())
            return self._sorted
        keys = torch.cat(self._keys)
        seqs = torch.cat(self._seqs)
        # Stable sort on key keeps insertion order among equal keys; take the
        # last occurrence of each key (highest seq, since seqs increase).
        keys, order = torch.sort(keys, stable=True)
        seqs = seqs[order]
        last = torch.ones_like(keys, dtype=torch.bool)
        last[:-1] = keys[1:] != keys[:-1]
        self._sorted = (keys[last], seqs[last])
        return self._sorted

    def scan_from(self, key: int, m: int
                  ) -> tuple[torch.Tensor, torch.Tensor, bool]:
        """First ``m`` entries with key >= ``key`` (sorted, deduped) plus a
        flag saying whether more remain past the cap."""
        ks, ss = self.to_sorted()
        probe = torch.tensor([key], dtype=torch.int64, device=ks.device)
        i = int(fence_rank(ks, probe, "left")[0])
        return ks[i:i + m], ss[i:i + m], (ks.shape[0] - i) > m

    def get_batch(self, keys: torch.Tensor) -> torch.Tensor:
        """Vectorized :meth:`get` over many device keys; -1 marks a miss."""
        sk, ss = self.to_sorted()
        if sk.shape[0] == 0:
            return torch.full_like(keys, -1)
        pos = fence_rank(sk, keys, "left").clamp_(max=sk.shape[0] - 1)
        hit = sk[pos] == keys
        return torch.where(hit, ss[pos], -1)

    def to_sst(self) -> SST:
        keys, seqs = self.to_sorted()
        return SST(keys, seqs, self.kv_size)
