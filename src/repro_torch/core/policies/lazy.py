"""Lazy leveling (Dostoevsky-style), the registry's proof-of-API policy.

Dostoevsky's *lazy leveling* (Dayan & Idreos, 2018) merges greedily only
at the largest level — which dominates space and read cost — and merges
*lazily* everywhere above it, trading intermediate-level write
amplification for bounded point-read and space overheads.

Mapping onto this engine's mechanism (levels >= 1 stay sorted and
pairwise disjoint, so a disjoint full level IS one sorted run):

* **L0**: tiering — accumulate the trigger count, then one wide merge of
  ALL L0 SSTs into L1 (lazy at the top).
* **Intermediate levels** (1 .. max-3): no per-SST scheduling.  A full
  level moves *wholesale* into the next one as a single wide compaction —
  the disjoint-level expression of moving a tiered run down.  Combined
  with a generous debt factor, compactions here are rare and wide.
* **Bottom transition** (level max-2 -> the last level): the default
  leveled min-overlap pick, one SST at a time — greedy at the bottom, so
  the largest level keeps leveled read/space behaviour.

The policy is written purely against the public mechanism interface
(``tree.merge_down`` / ``tree.overlap`` / the LevelIndex fence arrays):
a wholesale move is one ``merge_down`` whose merges run on the compute
device like any other compaction's.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..sst import total_size
from ..types import LSMConfig
from .base import CompactionPolicy
from .registry import register

if TYPE_CHECKING:
    from ..lsm import Job, LSMTree


class LazyLevelingPolicy(CompactionPolicy):
    name = "lazy"
    tiering_l0 = True
    # lazy: let intermediate levels run a bit past target before the
    # background sweep moves them wholesale.
    soft_limit_factor = 1.25

    def default_config(self, scale: int = 1 << 20) -> LSMConfig:
        return LSMConfig(
            memtable_size=scale, sst_size=scale, l0_max_ssts=4,
            policy=self.name, debt_factor=0.5, growth_factor=8,
        )

    def incoming_bytes(self, tree: "LSMTree", level: int) -> int:
        cfg = tree.cfg
        if 1 <= level < cfg.max_levels - 2:
            # a wholesale move pushes the whole level down at once
            return max(cfg.sst_size, total_size(tree.levels[level]))
        return super().incoming_bytes(tree, level)

    def pick_compaction(self, tree: "LSMTree", level: int,
                        deps: list["Job"]) -> "Job | None":
        lvl = tree.levels[level]
        if not lvl:
            return None
        if level < tree.cfg.max_levels - 2:
            # lazy: the full (disjoint == single-run) level moves wholesale
            return tree.merge_down(level, list(range(len(lvl))), deps)
        # greedy at the bottom: leveled min-overlap single-SST pick
        return super().pick_compaction(tree, level, deps)

    def chain_priority(self, cfg: LSMConfig, head: "Job",
                       chain_jobs: list["Job"]):
        """Lazy chain urgency: L0 relief first, bottom-level greedy picks
        next, and the wholesale intermediate moves — the *lazy* work this
        policy exists to defer — last.  They are huge and nothing
        foreground waits on them, so they soak up whatever slot time the
        urgent chains leave."""
        if any(j.level == 0 for j in chain_jobs):
            return (0, 0)
        wholesale = 1 <= head.level < cfg.max_levels - 2
        return (2, 0) if wholesale else (1, 0)

    def check_invariants(self, tree: "LSMTree") -> None:
        # all on-device SSTs are fixed-size cuts: never beyond S_M (+1 key)
        cfg = tree.cfg
        for level in range(1, cfg.max_levels):
            for sst in tree.levels[level]:
                assert sst.size <= cfg.sst_size + cfg.kv_size, \
                    "lazy-leveling SST exceeds the fixed S_M cut"


register(LazyLevelingPolicy())
