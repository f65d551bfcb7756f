"""RocksDB-family baselines (paper Fig 3b): tiering compaction in L0 —
when L0 fills, ALL L0 SSTs merge with ALL overlapping L1 SSTs (the wide
first chain stage) — then leveled min-overlap picks below.  ``rocksdb``
allows bounded compaction debt; ``rocksdb_io`` none (overflow disabled).

Chain shape (§3, the paper's tail-latency diagnosis): the tiering head
makes every flush-triggered chain *wide* — its fan-in is the whole of L0
plus the L1 overlap — so a stalled queue waits on a large, monolithic
merge.  Chain urgency stays the base default (L0-relieving chains before
background sweeps, RocksDB's own low-pri boost)."""

from __future__ import annotations

from ..types import LSMConfig
from .base import CompactionPolicy
from .registry import register


class RocksDBPolicy(CompactionPolicy):
    name = "rocksdb"
    tiering_l0 = True

    def default_config(self, scale: int = 1 << 20) -> LSMConfig:
        """RocksDB defaults at a byte ``scale`` standing in for 64 MB."""
        return LSMConfig(
            memtable_size=scale, sst_size=scale, l0_max_ssts=4,
            policy=self.name, debt_factor=0.25, growth_factor=8,
        )


class RocksDBIOPolicy(RocksDBPolicy):
    name = "rocksdb_io"

    def default_config(self, scale: int = 1 << 20) -> LSMConfig:
        return RocksDBPolicy.default_config(self, scale).with_(
            debt_factor=0.0)


register(RocksDBPolicy())
register(RocksDBIOPolicy())
