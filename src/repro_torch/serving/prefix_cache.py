"""LSM-backed prefix cache — the store serving the serving stack; the port
of ``repro/serving/prefix_cache.py``.

Shared prompt prefixes map token-block hashes to pinned KV pages.  The
index is the port's :class:`~repro_torch.core.LSMTree` under the vLSM
policy on the compute device, so every lookup is a GET through the
overlap_scan kernel.  Key = blake2b hash of the token prefix at each block
boundary; the LSM's seqno is the handle into ``entries``.  Lookup walks
block boundaries longest-first; eviction releases pages of the least-hit
entries.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import LSMConfig, LSMTree
from .kv_cache import PagePool


def _hash_tokens(tokens) -> int:
    h = hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & 0x7FFF_FFFF_FFFF_FFFF


@dataclass
class PrefixEntry:
    pages: list[int]
    n_tokens: int
    hits: int = 0


class PrefixCache:
    def __init__(self, pool: PagePool, block_tokens: int = 128,
                 lsm_cfg: LSMConfig | None = None,
                 compute_device: str | torch.device = "cuda"):
        self.pool = pool
        self.block = block_tokens
        self.index = LSMTree(lsm_cfg or LSMConfig.vlsm_default(scale=1 << 18)
                             .with_(kv_size=64),
                             compute_device=compute_device)
        self.entries: dict[int, PrefixEntry] = {}    # seq -> entry
        self.latest: dict[int, int] = {}             # key -> seq (fast map)

    # ----------------------------------------------------------- internal
    def _put(self, key: int) -> int:
        t = self.index
        if t.memtable.room < 1:
            t.seal_memtable()
            t.flush_immutable()
            t.background_triggers()
            t.drain_jobs()
        seq = int(t.put_batch(np.asarray([key], np.int64))[0])
        self.latest[key] = seq
        return seq

    # -------------------------------------------------------------- insert
    def insert(self, tokens, pages_by_block: list[list[int]]) -> int:
        """Register prefix blocks of ``tokens``; pages get pinned.
        ``pages_by_block[i]`` are the pool pages holding block i."""
        n_blocks = min(len(tokens) // self.block, len(pages_by_block))
        inserted = 0
        for i in range(n_blocks):
            key = _hash_tokens(tokens[:(i + 1) * self.block])
            if key in self.latest:
                continue
            seq = self._put(key)
            for p in pages_by_block[i]:
                self.pool.pin(p)
            self.entries[seq] = PrefixEntry(pages=list(pages_by_block[i]),
                                            n_tokens=(i + 1) * self.block)
            inserted += 1
        return inserted

    # -------------------------------------------------------------- lookup
    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: (n_tokens, pages)."""
        n_blocks = len(tokens) // self.block
        for i in range(n_blocks, 0, -1):
            key = _hash_tokens(tokens[:i * self.block])
            seq, _reads, _probed = self.index.get(int(key))
            if seq is not None and seq in self.entries:
                self.entries[seq].hits += 1
                pages: list[int] = []
                # assemble the chain of blocks 1..i
                for j in range(1, i + 1):
                    sj = self.latest.get(_hash_tokens(tokens[:j * self.block]))
                    if sj is None or sj not in self.entries:
                        break
                    pages.extend(self.entries[sj].pages)
                else:
                    return i * self.block, pages
        return 0, []

    # -------------------------------------------------------------- evict
    def evict_lru(self, n_entries: int = 1) -> int:
        """Release the least-hit entries' pages (capacity pressure)."""
        victims = sorted(self.entries.items(),
                         key=lambda kv: (kv[1].hits, kv[0]))[:n_entries]
        for seq, entry in victims:
            for p in entry.pages:
                self.pool.release(p)
            del self.entries[seq]
            for k in [k for k, s in self.latest.items() if s == seq]:
                del self.latest[k]
        return len(victims)

    def stats(self) -> dict:
        return {"entries": len(self.entries),
                "index": self.index.stats.summary(),
                "free_pages": self.pool.free_pages}
