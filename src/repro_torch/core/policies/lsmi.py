"""LSMi (paper Fig 3a): incremental compaction without L0 tiering and
fixed-size L1 SSTs — one L0 SST at a time, but every compaction rewrites
the whole overlap.

Chain shape: the incremental head keeps chains *narrow* (fan-in = 1 L0
SST + its L1 overlap), but without vLSM's phi/vSSTs the chains run long —
each pop cascades through more levels before the trigger clears."""

from __future__ import annotations

from ..types import LSMConfig
from .base import CompactionPolicy
from .registry import register


class LSMIPolicy(CompactionPolicy):
    name = "lsmi"
    tiering_l0 = False

    def default_config(self, scale: int = 1 << 20) -> LSMConfig:
        return LSMConfig(
            memtable_size=scale, sst_size=scale, l0_max_ssts=4,
            policy=self.name, debt_factor=0.0, growth_factor=8,
        )


register(LSMIPolicy())
