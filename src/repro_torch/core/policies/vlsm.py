"""vLSM (paper Fig 3d): no L0 tiering, small SSTs, growth factor ``phi``
between L1 and L2, and overlap-aware vSSTs in L1 with good/poor selection
(§4.2)."""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ...trace import span
from ..sst import SST, ssts_from_cuts
from ..types import LSMConfig
from ..vsst import plan_vssts, select_good_vssts
from .base import CompactionPolicy
from .registry import register

if TYPE_CHECKING:
    from ..lsm import Job, LSMTree


class VLSMPolicy(CompactionPolicy):
    name = "vlsm"
    tiering_l0 = False

    def default_config(self, scale: int = 1 << 20,
                       sst_frac: int = 8) -> LSMConfig:
        """vLSM §5 defaults: SSTs S_M = scale/sst_frac (8 MB when scale=64
        MB), memtable == S_M, L1 = f*S_M, phi = 32 between L1 and L2."""
        sst = max(1, scale // sst_frac)
        return LSMConfig(
            memtable_size=sst, sst_size=sst, l0_max_ssts=4,
            policy=self.name, debt_factor=0.0, growth_factor=8, phi=32,
        )

    def level_target(self, cfg: LSMConfig, level: int) -> int:
        if level < 1:
            return cfg.l0_max_ssts * cfg.memtable_size
        l1 = cfg.growth_factor * cfg.sst_size
        if level == 1:
            return l1
        l2 = cfg.phi * l1
        return l2 * cfg.growth_factor ** (level - 2)

    def build_l1_ssts(self, tree: "LSMTree", keys: torch.Tensor,
                      seqs: torch.Tensor) -> list[SST]:
        """Cut the merged L1 stream into overlap-aware vSSTs (§4.2)."""
        with span("store.vsst_plan"):
            cfg = tree.cfg
            fence_lo, fence_hi = tree.index.fences(2)
            plans = plan_vssts(keys, cfg.kv_size, cfg.s_m, cfg.s_M,
                               cfg.growth_factor, fence_lo, fence_hi,
                               cfg.sst_size)
            # per-key look-ahead
            tree.stats.overlap_probes += int(keys.shape[0])
            out = ssts_from_cuts(keys, seqs, cfg.kv_size,
                                 [p.start for p in plans],
                                 [p.end for p in plans])
            for p, sst in zip(plans, out):
                if p.good:
                    tree.stats.vssts_good += 1
                    tree.stats.vsst_good_bytes += sst.size
                else:
                    tree.stats.vssts_poor += 1
                    tree.stats.vsst_poor_bytes += sst.size
            return out

    def pick_compaction(self, tree: "LSMTree", level: int,
                        deps: list["Job"]) -> "Job | None":
        if level == 1:
            return self._vlsm_l1(tree, deps)
        return super().pick_compaction(tree, level, deps)

    def _vlsm_l1(self, tree: "LSMTree", deps: list["Job"]) -> "Job | None":
        """§4.2.2: compact a set of *good* vSSTs whose cumulative size
        frees room for the next L0 SST."""
        cfg = tree.cfg
        l1 = tree.levels[1]
        if not l1:
            return None
        fence_lo, fence_hi = tree.index.fences(2)
        # One batched overlap query scores every L1 vSST against L2.
        ov = tree.index.overlap_counts(2, *tree.index.fences(1))
        picked = select_good_vssts(l1, fence_lo, fence_hi, cfg.sst_size,
                                   cfg.growth_factor, cfg.sst_size, ov=ov)
        tree.stats.overlap_probes += len(l1)
        if not picked:
            # Φ too large: no good vSSTs exist (paper's Fig 13 failure mode).
            # Fall back to the least-bad vSST so the store still progresses.
            ratios = ov * cfg.sst_size / np.maximum(1, tree.index.sizes[1])
            picked = [int(np.argmin(ratios))]
        return tree.merge_down(1, picked, deps)

    def chain_priority(self, cfg: LSMConfig, head: "Job",
                       chain_jobs: list["Job"]):
        """vLSM chain urgency: L0-pressure chains first, and among equals
        the *narrowest* chain (fewest total bytes) first — with many small
        incremental chains in flight, clearing the cheapest L0 slot
        soonest is what keeps the write-stop gate open (§4.1's narrow
        chains are the asset; schedule them like one)."""
        tier = 0 if any(j.level == 0 for j in chain_jobs) else 1
        return (tier, sum(j.total_bytes for j in chain_jobs))

    def check_invariants(self, tree: "LSMTree") -> None:
        for sst in tree.levels[1]:
            # S_M plus the tail-absorption slack: a trailing fragment
            # smaller than S_m merges into its predecessor (§4.2), so a
            # vSST may legitimately reach S_M + S_m.
            assert sst.size <= tree.cfg.s_M + tree.cfg.s_m + tree.cfg.kv_size, \
                "vSST exceeds S_M + S_m tail slack"


register(VLSMPolicy())
