"""Instrumentation: I/O amplification, compaction chains, vSST quality, CPU proxy.

Host-side ledgers, the same as the reference's ``repro.core.stats``: the
counters are Python ints and the chain ledger is plain records.

Every quantity the paper plots is derived from these counters:

* I/O amplification  = (flush + compaction device writes) / user bytes
* chain width/length = recorded per blocking L0 trigger (Figs 2 & 9)
* write stalls       = filled in by the DES (``repro_torch.core.sim``)
* CPU efficiency     = cycle proxy from real work counters (merged keys,
                       per-key overlap probes, SSTs created / manifest
                       flushes) — the monotone stand-in for mpstat cycles/op.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ChainRecord:
    """One first-class compaction chain: the cascade of dependent
    compaction :class:`~repro_torch.core.lsm.Job` records triggered to free
    space for L0/memtable (``trigger="l0"``) or by the soft over-target
    sweep (``trigger="background"``).

    The structural fields are filled by ``LSMTree`` when the chain is
    emitted; the temporal fields (``t_start``/``t_finish``/``stall_s``)
    are filled by the DES scheduler once the chain's jobs get device
    time.  Paper semantics (§3): *width* is the head stage's input
    fan-in — L0 tiering merges ALL L0 SSTs plus the L1 overlap into one
    wide head, incremental designs pop a single SST — and *length* is
    the number of levels the chain traverses before the trigger clears.
    """

    chain_id: int = -1
    trigger: str = "l0"    # "l0" (flush-triggered) | "background"
    length: int = 0        # number of level-to-level stages (distinct levels)
    width: int = 0         # head fan-in: L0 SSTs the head consumed (the
                           # paper's tiering fan-in; background chains fall
                           # back to the head's total input SST count)
    width_bytes: int = 0   # total bytes read+written across the chain
    stage_bytes: list[int] = field(default_factory=list)
    n_jobs: int = 0
    job_uids: list[int] = field(default_factory=list)
    # filled by the DES scheduler:
    t_start: float = math.inf   # earliest job start on the device
    t_finish: float = 0.0       # latest job finish (the chain clears here)
    stall_s: float = 0.0        # foreground stall attributed to this chain

    @property
    def critical_path_s(self) -> float:
        """Wall-clock the chain occupied end-to-end on the device: the
        dependency edges serialize the stages, so this is the span from
        the first stage's start to the head's finish (0 if unscheduled)."""
        if not math.isfinite(self.t_start) or self.t_finish <= self.t_start:
            return 0.0
        return self.t_finish - self.t_start


@dataclass
class TenantLedger:
    """Per-tenant serving ledger (open-loop traffic layer).

    Written by the serving layer's ``serve`` into the owning shard's
    :class:`Stats` (one ledger per tenant per shard), so the fleet view
    aggregates tenants across shards like every other counter.  The
    conservation invariant — every offered op got exactly one verdict —
    is ``ops_offered == ops_admitted + ops_shed + ops_throttled``,
    re-asserted at runtime under ``cfg.paranoid_checks``.
    """

    name: str
    priority: int = 0
    slo_ms: float = 0.0
    ops_offered: int = 0
    ops_admitted: int = 0
    ops_shed: int = 0
    ops_throttled: int = 0
    slo_violations: int = 0         # admitted ops finishing past slo_ms

    @property
    def shed_frac(self) -> float:
        return self.ops_shed / max(1, self.ops_offered)

    @property
    def throttled_frac(self) -> float:
        return self.ops_throttled / max(1, self.ops_offered)

    @property
    def slo_violation_frac(self) -> float:
        return self.slo_violations / max(1, self.ops_admitted)

    def goodput_ops_s(self, duration_s: float) -> float:
        """Admitted ops that met the SLO, per second of measured time."""
        return (self.ops_admitted - self.slo_violations) \
            / max(duration_s, 1e-12)

    def merge_from(self, other: "TenantLedger") -> "TenantLedger":
        assert self.name == other.name, \
            f"merging ledgers of different tenants ({self.name} vs " \
            f"{other.name})"
        for f in ("ops_offered", "ops_admitted", "ops_shed",
                  "ops_throttled", "slo_violations"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def summary(self) -> dict:
        return {
            "tenant": self.name,
            "priority": self.priority,
            "slo_ms": self.slo_ms,
            "ops_offered": self.ops_offered,
            "shed_frac": round(self.shed_frac, 4),
            "throttled_frac": round(self.throttled_frac, 4),
            "slo_violation_frac": round(self.slo_violation_frac, 4),
        }


# CPU-cycle proxy coefficients (constant across all policies, so ratios are
# meaningful): cycles per merged key, per overlap probe, per SST created,
# per manifest flush, per op baseline.
CYC_MERGE_KEY = 30.0
CYC_OVERLAP_PROBE = 60.0
CYC_SST_CREATE = 200_000.0
CYC_MANIFEST_FLUSH = 400_000.0
CYC_OP_BASE = 2_000.0


@dataclass
class Stats:
    # I/O accounting
    user_bytes: int = 0
    flush_bytes: int = 0
    compact_bytes_read: int = 0
    compact_bytes_written: int = 0
    device_reads: int = 0            # point-lookup block reads
    scan_blocks: int = 0             # range-scan device block reads
    # work counters (CPU proxy)
    merged_keys: int = 0
    overlap_probes: int = 0
    ssts_created: int = 0
    manifest_flushes: int = 0
    ops: int = 0
    # typed-op surface (DELETE tombstones, SCAN traffic)
    delete_ops: int = 0              # tombstones written (user DELETEs)
    scan_ops: int = 0
    tombstones_dropped: int = 0      # markers reclaimed at the bottom level
    tombstone_bytes_dropped: int = 0
    # structural records: the chain ledger (ALL chains, l0 + background;
    # chain_index is the DES's O(1) chain_id -> record lookup)
    chains: list[ChainRecord] = field(default_factory=list)
    chain_index: dict[int, ChainRecord] = field(default_factory=dict)
    vssts_good: int = 0
    vssts_poor: int = 0
    vsst_good_bytes: int = 0
    vsst_poor_bytes: int = 0
    compactions_per_level: dict[int, int] = field(default_factory=dict)
    level_bytes_moved: dict[int, int] = field(default_factory=dict)
    # serving-layer admission accounting: offered traffic
    # ops routed to this shard and their verdicts; ops never silently
    # dropped — shed + throttled + admitted == offered per tenant
    ops_offered: int = 0
    ops_shed: int = 0
    ops_throttled: int = 0
    slo_violations: int = 0
    tenants: dict[str, TenantLedger] = field(default_factory=dict)

    # ------------------------------------------------------------- derived
    @property
    def write_amp(self) -> float:
        if self.user_bytes == 0:
            return 0.0
        return (self.flush_bytes + self.compact_bytes_written) / self.user_bytes

    @property
    def io_amp(self) -> float:
        """Read+write device traffic over user bytes (paper's I/O amp)."""
        if self.user_bytes == 0:
            return 0.0
        total = (self.flush_bytes + self.compact_bytes_written
                 + self.compact_bytes_read)
        return total / self.user_bytes

    @property
    def cpu_cycles_per_op(self) -> float:
        if self.ops == 0:
            return 0.0
        cyc = (CYC_MERGE_KEY * self.merged_keys
               + CYC_OVERLAP_PROBE * self.overlap_probes
               + CYC_SST_CREATE * self.ssts_created
               + CYC_MANIFEST_FLUSH * self.manifest_flushes
               + CYC_OP_BASE * self.ops)
        return cyc / self.ops

    @property
    def tombstones_live(self) -> int:
        """DELETE markers still occupying device space (space amplification
        pressure: written but not yet reclaimed at the bottom level)."""
        return max(0, self.delete_ops - self.tombstones_dropped)

    # --------------------------------------------------- the chain ledger
    def record_chain(self, rec: ChainRecord) -> ChainRecord:
        """Append a chain to the ledger and index it for the DES."""
        self.chains.append(rec)
        self.chain_index[rec.chain_id] = rec
        return rec

    @property
    def l0_chains(self) -> list[ChainRecord]:
        """Flush-triggered chains only — the paper's Figs 2 & 9 population
        (background soft-limit sweeps are ledgered but reported apart)."""
        return [c for c in self.chains if c.trigger == "l0"]

    @property
    def mean_chain_width(self) -> float:
        chains = self.l0_chains
        if not chains:
            return 0.0
        return sum(c.width_bytes for c in chains) / len(chains)

    @property
    def max_chain_width(self) -> int:
        return max((c.width_bytes for c in self.l0_chains), default=0)

    @property
    def mean_chain_length(self) -> float:
        chains = self.l0_chains
        if not chains:
            return 0.0
        return sum(c.length for c in chains) / len(chains)

    @property
    def mean_chain_fanin(self) -> float:
        """Mean head-stage L0 fan-in over flush-triggered chains — the
        paper's chain *width* in file terms (tiering ~= l0_max_ssts,
        incremental = 1)."""
        chains = self.l0_chains
        if not chains:
            return 0.0
        return sum(c.width for c in chains) / len(chains)

    @property
    def effective_chain_length(self) -> float:
        """Compaction stages each L0 relief *forces*, counting the debt
        catch-up that debt designs defer into background sweeps: total
        stages across the whole ledger over the number of flush-triggered
        chains.  For no-debt policies this equals the raw mean length;
        for debt designs it surfaces the deferred part of the cascade —
        the paper's chain *length* on an equal footing across policies."""
        n_l0 = len(self.l0_chains)
        if n_l0 == 0:
            return 0.0
        return sum(c.length for c in self.chains) / n_l0

    def chain_report(self) -> dict:
        """Distribution summary of the chain ledger (the chain observatory).

        Width (head fan-in, SSTs), length (levels traversed), and
        critical-path duration P50/P99 over flush-triggered chains, plus
        the background-chain count and the total foreground stall time
        the DES attributed to chains.  This is the payload of db_bench's
        ``chain_report`` rows (see ``docs/benchmarks.md``)."""
        chains = self.l0_chains
        out = {
            "n_chains": len(chains),
            "n_background_chains": len(self.chains) - len(chains),
            "stall_attributed_s": round(
                sum(c.stall_s for c in self.chains), 4),
        }
        if not chains:
            return out
        width = np.array([c.width for c in chains], np.float64)
        length = np.array([c.length for c in chains], np.float64)
        crit = np.array([c.critical_path_s for c in chains], np.float64)
        out.update({
            "mean_width_ssts": round(float(width.mean()), 2),
            "p50_width_ssts": float(np.percentile(width, 50)),
            "p99_width_ssts": float(np.percentile(width, 99)),
            "max_width_ssts": int(width.max()),
            "mean_length": round(float(length.mean()), 2),
            "effective_length": round(self.effective_chain_length, 2),
            "p50_length": float(np.percentile(length, 50)),
            "p99_length": float(np.percentile(length, 99)),
            "max_length": int(length.max()),
            "p50_critical_path_ms": round(
                float(np.percentile(crit, 50)) * 1e3, 3),
            "p99_critical_path_ms": round(
                float(np.percentile(crit, 99)) * 1e3, 3),
            "mean_width_mb": round(self.mean_chain_width / 1e6, 3),
        })
        return out

    def merge_from(self, other: "Stats") -> "Stats":
        """Accumulate another ledger into this one (fleet aggregation):
        numeric counters add, chain ledgers concatenate (chain ids are
        process-global so the merged index stays collision-free), per-level
        dicts merge-add.  Returns self."""
        for f in dataclasses.fields(Stats):
            if f.name in ("chains", "chain_index", "tenants",
                          "compactions_per_level", "level_bytes_moved"):
                continue
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        self.chains.extend(other.chains)
        self.chain_index.update(other.chain_index)
        for name, led in other.tenants.items():
            if name in self.tenants:
                self.tenants[name].merge_from(led)
            else:
                self.tenants[name] = dataclasses.replace(led)
        for lvl, n in other.compactions_per_level.items():
            self.compactions_per_level[lvl] = \
                self.compactions_per_level.get(lvl, 0) + n
        for lvl, b in other.level_bytes_moved.items():
            self.level_bytes_moved[lvl] = \
                self.level_bytes_moved.get(lvl, 0) + b
        return self

    def note_compaction(self, level: int, bytes_moved: int) -> None:
        self.compactions_per_level[level] = self.compactions_per_level.get(level, 0) + 1
        self.level_bytes_moved[level] = self.level_bytes_moved.get(level, 0) + bytes_moved

    def summary(self) -> dict:
        out = {
            "io_amp": round(self.io_amp, 2),
            "write_amp": round(self.write_amp, 2),
            "chains": len(self.l0_chains),
            "bg_chains": len(self.chains) - len(self.l0_chains),
            "mean_chain_width_mb": round(self.mean_chain_width / 1e6, 3),
            "max_chain_width_mb": round(self.max_chain_width / 1e6, 3),
            "mean_chain_length": round(self.mean_chain_length, 2),
            "cycles_per_op": round(self.cpu_cycles_per_op, 0),
            "vssts_good": self.vssts_good,
            "vssts_poor": self.vssts_poor,
        }
        if self.delete_ops or self.scan_ops:
            out.update({
                "delete_ops": self.delete_ops,
                "scan_ops": self.scan_ops,
                "scan_blocks": self.scan_blocks,
                "tombstones_dropped": self.tombstones_dropped,
                "tombstones_live": self.tombstones_live,
            })
        if self.ops_offered:
            admitted = (self.ops_offered - self.ops_shed
                        - self.ops_throttled)
            out.update({
                "ops_offered": self.ops_offered,
                "ops_shed": self.ops_shed,
                "ops_throttled": self.ops_throttled,
                "shed_frac": round(self.ops_shed / self.ops_offered, 4),
                "slo_violation_frac": round(
                    self.slo_violations / max(1, admitted), 4),
                "per_tenant": [self.tenants[k].summary()
                               for k in sorted(self.tenants)],
            })
        return out


class FleetStats:
    """Read-only fleet-wide view over a sharded store's per-shard ledgers.

    Each shard's :class:`LSMTree` writes into its OWN :class:`Stats`
    (per-shard observability stays first-class); this wrapper aggregates
    them on demand into the familiar ``Stats`` read API — ``io_amp``,
    ``chains``, ``summary()``, ``chain_report()``, … all delegate to a
    freshly merged snapshot, so a `FleetStats` can stand wherever a
    ``Stats`` is only *read*.  Writes are refused (``__setattr__``): the
    DES and the trees must mutate the owning shard's ledger directly, or
    fleet counters would silently land in a throwaway snapshot.
    """

    def __init__(self, shards: list[Stats]):
        object.__setattr__(self, "shards", list(shards))

    def __setattr__(self, name, value):
        raise AttributeError(
            "FleetStats is a read-only aggregate; mutate the per-shard "
            "Stats (FleetStats.shards[i]) instead")

    def merged(self) -> Stats:
        """A fresh Stats holding the fleet-wide aggregate (counters
        summed, chain ledgers concatenated shard-major)."""
        out = Stats()
        for st in self.shards:
            out.merge_from(st)
        return out

    # Stats methods that mutate their receiver: reached through
    # __getattr__ they would operate on the throwaway merged snapshot
    # and vanish silently, so refuse them like attribute writes.
    _MUTATORS = frozenset({"note_compaction", "record_chain", "merge_from"})

    def __reduce__(self):
        # Explicit pickle protocol: the default path probes
        # ``__getstate__`` via getattr, which lands in __getattr__ →
        # merged() → self.shards → __getattr__ … and recurses forever.
        return (FleetStats, (self.shards,))

    def __getattr__(self, name):
        # every Stats read (property, counter, or method) via the merged
        # snapshot; AttributeError propagates naturally for unknown names.
        # Dunder probes (pickle/copy protocol discovery, IPython reprs)
        # must fail fast instead of delegating into merged().
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        if name in FleetStats._MUTATORS:
            raise AttributeError(
                f"Stats.{name} mutates its receiver; call it on the "
                f"owning shard's Stats (FleetStats.shards[i]), not the "
                f"read-only aggregate")
        return getattr(self.merged(), name)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def per_shard_summary(self) -> list[dict]:
        """One ``Stats.summary()`` row per shard, shard order."""
        return [st.summary() for st in self.shards]

    def chain_report(self) -> dict:
        """Fleet chain observatory: the merged distributions plus a
        ``per_shard`` breakdown (chain counts + attributed stall per
        shard) — the cross-shard interference signal: ONE hot shard's
        chains soaking up the stall attribution while every shard's
        reads ride the same busy device."""
        out = self.merged().chain_report()
        out["per_shard"] = [
            {
                "shard": s,
                "n_chains": len(st.l0_chains),
                "n_background_chains": len(st.chains) - len(st.l0_chains),
                "stall_attributed_s": round(
                    sum(c.stall_s for c in st.chains), 4),
                "io_amp": round(st.io_amp, 2),
            }
            for s, st in enumerate(self.shards)
        ]
        return out

    def summary(self) -> dict:
        out = self.merged().summary()
        user = [st.user_bytes for st in self.shards]
        total = sum(user)
        if total:
            # write-load-balance signal: hottest shard's share of user
            # bytes, whole run (1/n_shards = perfectly balanced).  Named
            # apart from shard_sweep's hot_shard_frac, which is the
            # hottest shard's share of measured-phase OPS.
            out["hot_shard_bytes_frac"] = round(max(user) / total, 3)
        return out
