"""ADOC (paper Fig 3c): tiering L0 plus large compaction debt and batched
background compactions — the scheduling approach.  Levels intentionally run
*past* target (debt, §3.3) and only compact in big batches once they exceed
1.5x target: that is the mechanism by which ADOC trades I/O amplification
(larger overlaps while overfull) for fewer stalls.

Chain shape: the tiering head is as wide as RocksDB's, but the debt
batching shifts work into *background* chains (soft-limit sweeps) that the
chain-aware DES pool runs at lower urgency than L0 relief — ADOC's
scheduling idea expressed as chain priority."""

from __future__ import annotations

from ..types import LSMConfig
from .registry import register
from .rocksdb import RocksDBPolicy


class ADOCPolicy(RocksDBPolicy):
    name = "adoc"
    soft_limit_factor = 1.5

    def default_config(self, scale: int = 1 << 20) -> LSMConfig:
        return RocksDBPolicy.default_config(self, scale).with_(
            debt_factor=1.0, adoc_batch=4)

    def pick_batch(self, cfg: LSMConfig) -> int:
        return cfg.adoc_batch


register(ADOCPolicy())
