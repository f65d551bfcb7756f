"""The abstract ``CompactionPolicy`` strategy interface.

The paper's core contribution is a *policy* (small SSTs, no L0 tiering,
large L1->L2 growth, overlap-aware L1 vSSTs) layered on an unchanged LSM
*mechanism*.  This module makes that split first-class: ``LSMTree`` owns
the mechanism (memtable, flush, splice, merge, LevelIndex, read paths) and
every compaction *decision* is delegated to a ``CompactionPolicy`` object
resolved by registry name (:mod:`repro_torch.core.policies.registry`).
The tree's payload arrays live on the compute device; every hook here
works on host scalars and the LevelIndex's host arrays, and hands device
runs to the mechanism primitives.

A policy owns:

* **L0 strategy** — :meth:`compact_l0`, built from the two shared bodies
  :meth:`_tiering_l0` (merge ALL of L0 with ALL overlapping L1, RocksDB
  family) and :meth:`_incremental_l0` (pop ONE FIFO L0 SST, vLSM/LSMi);
* **level pick & scoring** — :meth:`pick_compaction` (default: RocksDB's
  min overlap-ratio scheduler over the LevelIndex fence arrays);
* **SST sizing & build** — :meth:`build_l1_ssts` (default: fixed-size
  ``split_fixed``; vLSM overrides with overlap-aware vSST planning);
* **stall / debt parameters** — :attr:`soft_limit_factor`,
  :meth:`level_target` / :meth:`level_limit`, and the DES stall gates
  :meth:`l0_stop_ssts` / :meth:`write_buffer_limit`;
* **chain scheduling urgency** — :meth:`chain_priority`, the sort key the
  DES's chain-aware compaction pool orders drained chains by (vLSM and
  lazy override it; see ``docs/architecture.md``);
* **config defaults** — :meth:`default_config`, the policy's canned
  ``LSMConfig`` (what ``LSMConfig.rocksdb_default`` et al. delegate to);
* **policy-specific invariants** — :meth:`check_invariants`, run by the
  mechanism's own invariant sweep (continuously when
  ``cfg.paranoid_checks`` is on).

Writing a new policy means subclassing this, overriding the hooks that
differ, and calling ``registry.register(YourPolicy())`` — no edits to
``lsm.py`` / ``sim.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..sst import split_fixed, total_size
from ..types import LSMConfig

if TYPE_CHECKING:  # mechanism types, imported lazily to avoid a cycle
    from ..lsm import Job, LSMTree

#: The public mechanism surface: the only ``tree`` methods a policy may
#: call to mutate structure (the contract table below renders it).
MECHANISM_PRIMITIVES = (
    "emit_compact_job",
    "merge_down",
    "merge_runs",
    "overlap",
    "replace_in_level",
    "strip_bottom_tombstones",
)
#: Read-only ``tree.index`` queries policies may use for scoring.
INDEX_QUERIES = (
    "check_against",
    "fences",
    "n_ssts",
    "overlap_bytes",
    "overlap_counts",
    "overlap_ranges",
    "overlap_slice",
    "scan_spans",
    "size_prefix",
)
#: ``tree.index`` mutators owned by the two shared L0 bodies — policies
#: never call these anywhere else.
L0_INDEX_MUTATORS = ("l0_clear", "l0_popleft")


class CompactionPolicy:
    """Strategy base class: every hook has the RocksDB-leveled default.

    Hook contract, common to all of them:

    * Hooks receive the live ``LSMTree`` (or its frozen ``LSMConfig``) —
      they may *read* anything, but must mutate structure **only**
      through the mechanism primitives (``tree.merge_down``,
      ``tree.merge_runs``, ``tree.overlap``, ``tree.replace_in_level``,
      ``tree.strip_bottom_tombstones``, ``tree.emit_compact_job``).
      Never touch ``tree.levels`` / ``tree.index`` except via L0
      ownership inside the two shared L0 bodies.
    * ``cfg`` is a frozen dataclass: never mutated, derive with
      ``cfg.with_(...)``.
    * Pure *parameter* hooks (``level_target``, ``l0_stop_ssts``, ...)
      must be deterministic functions of their inputs — the DES calls
      them repeatedly and assumes stable answers.

    .. contract-table-start

    Hook surface (generated; regenerate with ``python -m repro_torch.analysis --write-contract-table``):

    default_config(scale, **kw)            [required]
    level_target(cfg, level)               [default provided]
    level_limit(cfg, level)                [default provided]
    l0_stop_ssts(cfg)                      [default provided]
    write_buffer_limit(cfg)                [default provided]
    chain_priority(cfg, head, chain_jobs)  [default provided]
    pick_batch(cfg)                        [default provided]
    incoming_bytes(tree, level)            [default provided]
    compact_l0(tree, deps)                 [default provided]
    pick_compaction(tree, level, deps)     [default provided]
    build_l1_ssts(tree, keys, seqs)        [default provided]
    check_invariants(tree)                 [default provided]
    _tiering_l0(tree, deps)                [shared L0 body]
    _incremental_l0(tree, deps)            [shared L0 body]

    mechanism primitives (the only tree mutators policies may call):
      emit_compact_job, merge_down, merge_runs, overlap, replace_in_level, strip_bottom_tombstones
    read-only index queries:
      check_against, fences, n_ssts, overlap_bytes, overlap_counts, overlap_ranges, overlap_slice, scan_spans, size_prefix
    index mutators owned by the shared L0 bodies:
      l0_clear, l0_popleft

    .. contract-table-end
    """

    #: registry key; also the value carried in ``LSMConfig.policy``
    name: str = ""
    #: does L0 use a tiering (merge-all) compaction step?
    tiering_l0: bool = False
    #: background compactions fire once a level exceeds
    #: ``soft_limit_factor * level_target`` (ADOC's debt batching uses 1.5)
    soft_limit_factor: float = 1.0

    # ------------------------------------------------------ configuration
    def default_config(self, scale: int = 1 << 20, **kw) -> LSMConfig:
        """The policy's canned ``LSMConfig`` at a byte ``scale`` standing
        in for the paper's 64 MB.

        Contract: must return a config whose ``policy`` field round-trips
        (``cfg.policy == self.name``) so registry resolution is stable.
        Required override — the base class has no sensible default shape.
        """
        raise NotImplementedError

    def level_target(self, cfg: LSMConfig, level: int) -> int:
        """Target size in bytes for ``level`` (the L0 target is the
        trigger occupancy in bytes).

        Inputs: the frozen config and a level index ``0 <= level <
        cfg.max_levels``.  Must be pure (no tree access — targets are
        queried before trees exist).  Default: L1 sized like L0, then
        geometric ``growth_factor`` scaling."""
        if level < 1:
            return cfg.l0_max_ssts * cfg.memtable_size
        l1 = cfg.l0_max_ssts * cfg.memtable_size
        return l1 * cfg.growth_factor ** (level - 1)

    def level_limit(self, cfg: LSMConfig, level: int) -> int:
        """Hard size limit for ``level`` including compaction debt
        (overflow): the room-making recursion compacts a level before
        letting incoming bytes push it past this.  Default:
        ``level_target * (1 + cfg.debt_factor)``."""
        return int(self.level_target(cfg, level) * (1.0 + cfg.debt_factor))

    # --------------------------------------------------- DES stall gates
    def l0_stop_ssts(self, cfg: LSMConfig) -> int:
        """Temporal L0 occupancy (file count) at which the DES
        write-stops the foreground queue (RocksDB's level0_stop gate).
        Pure function of the config.  Default: ``cfg.l0_stop_ssts``."""
        return cfg.l0_stop_ssts

    def write_buffer_limit(self, cfg: LSMConfig) -> int:
        """Write buffers (active + immutable) a region may hold before a
        fill stalls on the in-flight flush (RocksDB's
        max_write_buffer_number).  Default: ``cfg.max_write_buffers``."""
        return cfg.max_write_buffers

    # ---------------------------------------------------- DES scheduling
    def chain_priority(self, cfg: LSMConfig, head: "Job",
                       chain_jobs: list["Job"]):
        """Urgency sort key for one compaction *chain* in the DES's
        chain-aware compaction pool (``ChainScheduler``).

        Inputs: the frozen config, the chain ``head`` (the job that
        relieves the trigger — the L0 stage of a flush-triggered chain),
        and the chain's jobs in emission order (deepest stage first,
        head last).  Returns any sortable key; **lower schedules
        earlier**, ties keep FIFO emission order.  Must not mutate the
        jobs — scheduling has not happened yet (``t_start``/``t_finish``
        are unset).

        Default (RocksDB low-pri semantics): chains containing an
        L0-source stage outrank background soft-limit sweeps."""
        return (0 if any(j.level == 0 for j in chain_jobs) else 1, 0)

    # ------------------------------------------------ structural strategy
    def pick_batch(self, cfg: LSMConfig) -> int:
        """SSTs picked per L1+ compaction job (ADOC batches several).
        Pure function of the config; must be >= 1.  Default: 1."""
        return 1

    def incoming_bytes(self, tree: "LSMTree", level: int) -> int:
        """Bytes one compaction from ``level`` pushes into ``level + 1`` —
        what the chain's room-making recursion must clear below.
        Read-only on the tree.  Default: the whole of L0 for tiering
        designs, one SST otherwise."""
        cfg = tree.cfg
        if level == 0:
            if self.tiering_l0:
                return total_size(tree.levels[0])
            return tree.levels[0][0].size if tree.levels[0] else cfg.sst_size
        return cfg.sst_size

    def compact_l0(self, tree: "LSMTree", deps: list["Job"]) -> "Job | None":
        """One L0 compaction pass (called when L0 is at its trigger).

        ``deps`` is the chain's dependency tail (the deeper job this
        stage must follow) and must be forwarded verbatim to
        ``emit_compact_job`` so chain lineage stays intact.  Returns the
        emitted head job, or ``None`` when there is nothing to do.
        Default: dispatch to the shared tiering/incremental body per
        :attr:`tiering_l0`."""
        if self.tiering_l0:
            return self._tiering_l0(tree, deps)
        return self._incremental_l0(tree, deps)

    def pick_compaction(self, tree: "LSMTree", level: int,
                        deps: list["Job"]) -> "Job | None":
        """Compact from ``level >= 1`` into ``level + 1``.

        Same ``deps`` forwarding contract as :meth:`compact_l0`; all
        mutation must go through ``tree.merge_down`` (or the other
        primitives).  Default: RocksDB's scheduler — the min
        overlap-ratio SST(s) first, scored with one batched LevelIndex
        fence query."""
        if not tree.levels[level]:
            return None
        scores = (tree.index.overlap_bytes(level, level + 1)
                  / np.maximum(1, tree.index.sizes[level]))
        order = np.lexsort((np.arange(scores.shape[0]), scores))
        picked = [int(i) for i in order[:self.pick_batch(tree.cfg)]]
        return tree.merge_down(level, picked, deps)

    def build_l1_ssts(self, tree: "LSMTree", keys: torch.Tensor,
                      seqs: torch.Tensor) -> list:
        """Cut an L0->L1 merged stream into L1 SSTs (the sizing hook).

        ``keys``/``seqs`` are the merged, tombstone-stripped stream; the
        hook must partition them into SSTs **without reordering or
        dropping entries** (the caller splices the result into L1 and
        accounts the bytes).  May read ``tree.index`` fences (vLSM scores
        L2 overlap) but must not mutate the tree.  Default: fixed-size
        ``split_fixed`` cuts; vLSM builds overlap-aware vSSTs."""
        cfg = tree.cfg
        return split_fixed(keys, seqs, cfg.kv_size, cfg.sst_size)

    def check_invariants(self, tree: "LSMTree") -> None:
        """Policy-specific structural invariants, run by the mechanism's
        own sweep after its sortedness/disjointness/index/chain checks —
        continuously when ``cfg.paranoid_checks`` is on.  Read-only;
        raise ``AssertionError`` on violation.  Default: none."""

    # ------------------------------------- shared L0 strategy bodies
    def _tiering_l0(self, tree: "LSMTree", deps: list["Job"]) -> "Job | None":
        """RocksDB-family: merge ALL of L0 with ALL overlapping L1."""
        l0 = tree.levels[0]
        if not l0:
            return None
        lo = int(tree.index.smallest[0].min())
        hi = int(tree.index.largest[0].max())
        l1_over = tree.overlap(1, lo, hi)
        runs = [(s.keys, s.seqs) for s in reversed(l0)]  # newest first
        runs += [(s.keys, s.seqs) for s in l1_over]
        keys, seqs = tree.merge_runs(runs)
        keys, seqs = tree.strip_bottom_tombstones(1, keys, seqs)
        new = self.build_l1_ssts(tree, keys, seqs)
        tree.replace_in_level(1, l1_over, new)
        read_b = total_size(l0) + total_size(l1_over)
        write_b = sum(s.size for s in new)
        n_l0 = len(l0)
        tree.levels[0] = []
        tree.index.l0_clear()
        job = tree.emit_compact_job(0, read_b, write_b,
                                    n_l0 + len(l1_over), len(new), deps)
        job.l0_consumed = n_l0
        return job

    def _incremental_l0(self, tree: "LSMTree",
                        deps: list["Job"]) -> "Job | None":
        """vLSM / LSMi: pick ONE L0 SST (FIFO) and merge into L1, building
        the outputs through :meth:`build_l1_ssts`."""
        l0 = tree.levels[0]
        if not l0:
            return None
        src = l0.pop(0)  # FIFO: oldest first (vLSM §4.1)
        tree.index.l0_popleft()
        l1_over = tree.overlap(1, src.smallest, src.largest)
        runs = [(src.keys, src.seqs)] + [(s.keys, s.seqs) for s in l1_over]
        keys, seqs = tree.merge_runs(runs)
        keys, seqs = tree.strip_bottom_tombstones(1, keys, seqs)
        new = self.build_l1_ssts(tree, keys, seqs)
        tree.replace_in_level(1, l1_over, new)
        read_b = src.size + total_size(l1_over)
        write_b = sum(s.size for s in new)
        job = tree.emit_compact_job(0, read_b, write_b,
                                    1 + len(l1_over), len(new), deps)
        job.l0_consumed = 1
        return job
