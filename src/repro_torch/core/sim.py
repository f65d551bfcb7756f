"""Discrete-event simulation of the KV server (open-loop, §5 methodology).

The paper measures tail latency with a modified YCSB that sends requests at
a *fixed rate* into an unbounded queue (coordinated-omission-free).  The sim
reproduces that exactly:

* arrivals are deterministic (rate R) — the open-loop generator;
* foreground service is ONE FIFO queue **per shard** (``cfg.n_shards``;
  one queue total for the classic single-tree store) with per-kind costs
  (:class:`repro_torch.core.types.OpKind`): constant CPU for PUT/DELETE, per-GET
  service from the store's *actual* probe work (device block reads ×
  device model), per-SCAN service from the files seeked and blocks spanned
  (sequential transfer) — read kinds are inflated while compactions keep
  the device busy;
* background work (flushes + compaction chains emitted by the eager
  structural LSM in :mod:`repro_torch.core.lsm`) runs on slot pools **shared by
  every shard** (``DeviceModel.compaction_slots`` — the device does not
  multiply with the shard count); job durations come from real bytes;
  jobs *sharing a source level* in the same tree serialize (RocksDB's
  per-level compaction exclusivity — the reason wide tiering chains cannot
  hide behind thread parallelism), while independent levels — and
  independent shards — overlap;
* structural events advance on the **processed clock**: a memtable fills
  when its last PUT is *serviced* (exact Lindley recursion maintained
  incrementally per shard), so under saturation compaction triggers spread
  out the way a real store's do instead of bunching at arrival time;
* write stalls are computed from *temporal* L0 occupancy per tree: every
  flushed SST occupies an L0 slot until the compaction job that consumed
  it finishes; a fill event stalls when occupancy ≥ the stop limit
  (RocksDB's write-stop), or when the previous flush is still in flight
  (write-buffer stall);
* end-to-end latency is the exact Lindley recursion over each shard's
  queue, vectorized:  D_i = S_i + max_{j<=i}(arr_j - S_{j-1}),
  lat_i = D_i - arr_i — then re-gathered in arrival order.

Sharding (``cfg.n_shards > 1``) couples the shards *only* through the
device: the foreground queues are independent, but all flushes and
compaction chains contend for the same slot pools and every shard's read
service is inflated by the global count of running compactions — one
shard's wide chain raises every shard's read tail (the cross-shard
interference scenario ``db_bench``'s ``shard_sweep`` measures).

Placement: the trees keep their arrays on ``compute_device`` (default
``"cuda"``); the event heap, slot pools, stall gates and the per-op
service/arrival arrays are host-side control, and the final per-shard
Lindley pass ships every shard's queue to the device as ONE ragged batch
for the lindley_scan kernel (``repro_torch.kernels.lindley_scan``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis.sanitizer import maybe_sanitizer
from ..kernels.lindley_scan.ops import lindley_batch
from ..trace import span
from .lsm import Job, LSMTree
from .policies import get_policy
from .shard import ShardRouter
from .stats import FleetStats, Stats
from .types import (DeviceModel, LSMConfig, OpKind, RequestBatch,
                    resolve_compute_device)
from .uids import UidNamespace

PUT_SERVICE = 1.5e-6      # CPU service per put/delete (s); ~0.7 Mops/s queue
GET_CPU = 2.0e-6          # CPU service per get before device reads
SCAN_CPU = 4.0e-6         # CPU service per scan before device reads (seek
                          # setup + iterator merge overhead)
SCAN_FILE_CPU = 2.0e-6    # per-file iterator CPU (heap entry, index block)
BUSY_ALPHA = 0.6          # read-service inflation per concurrently-running job


@dataclass
class SimResult:
    arrivals: np.ndarray
    latency: np.ndarray            # end-to-end per op (s)
    op_types: np.ndarray           # OpKind values (0 put, 1 get, 2 del, 3 scan)
    stall_total: float = 0.0
    stall_max: float = 0.0
    n_stalls: int = 0
    stats: Stats | FleetStats | None = None
    job_log: list[Job] = field(default_factory=list)
    makespan: float = 0.0
    get_reads: np.ndarray | None = None    # per-op device block reads
    get_probed: np.ndarray | None = None   # per-op SSTs probed (GET + SCAN)
    shard_ids: np.ndarray | None = None    # per-op shard (None: single tree)
    n_shards: int = 1
    stall_events: list[tuple[int, float]] = field(default_factory=list)
    # per-shard chain-ledger snapshot AT RESULT TIME: chain count and the
    # write-stop seconds the DES attributed to each shard's chains.  The
    # fleet engine's Stats are shared across temporal passes (the ledger's
    # temporal fields reflect the most recent pass), so per-pass results
    # carry their own snapshot here.
    chain_counts: list[int] | None = None
    chain_stall_s: list[float] | None = None

    def pct(self, q: float, op: int | None = None) -> float:
        lat = self.latency if op is None else self.latency[self.op_types == op]
        if lat.size == 0:
            return 0.0
        return float(np.percentile(lat, q))

    @property
    def p99(self) -> float:
        return self.pct(99)

    @property
    def p99_put(self) -> float:
        return self.pct(99, 0)

    @property
    def p99_get(self) -> float:
        return self.pct(99, 1)

    @property
    def p99_scan(self) -> float:
        return self.pct(99, int(OpKind.SCAN))

    # The paper reports P99.9 tails (§5); surface them per kind too.
    @property
    def p999(self) -> float:
        return self.pct(99.9)

    @property
    def p999_put(self) -> float:
        return self.pct(99.9, 0)

    @property
    def p999_get(self) -> float:
        return self.pct(99.9, 1)

    @property
    def p999_scan(self) -> float:
        return self.pct(99.9, int(OpKind.SCAN))

    @property
    def throughput(self) -> float:
        return self.arrivals.shape[0] / max(self.makespan, 1e-9)

    def chain_report(self) -> dict:
        """Chain observatory: width/length/critical-path distributions of
        the run's compaction chains (``Stats.chain_report``)."""
        return self.stats.chain_report() if self.stats is not None else {}

    def completions_timeline(self, bins: int = 100) -> tuple[np.ndarray, np.ndarray]:
        done = self.arrivals + self.latency
        hist, edges = np.histogram(done, bins=bins)
        centers = 0.5 * (edges[1:] + edges[:-1])
        widths = np.diff(edges)
        return centers, hist / np.maximum(widths, 1e-12)

    def summary(self) -> dict:
        out = {
            "p50_ms": round(self.pct(50) * 1e3, 3),
            "p90_ms": round(self.pct(90) * 1e3, 3),
            "p99_ms": round(self.pct(99) * 1e3, 3),
            "p999_ms": round(self.p999 * 1e3, 3),
            "p99_put_ms": round(self.p99_put * 1e3, 3),
            "p99_get_ms": round(self.p99_get * 1e3, 3),
            "p999_put_ms": round(self.p999_put * 1e3, 3),
            "p999_get_ms": round(self.p999_get * 1e3, 3),
            "stall_total_s": round(self.stall_total, 4),
            "stall_max_s": round(self.stall_max, 4),
            "n_stalls": self.n_stalls,
            "kops_s": round(self.throughput / 1e3, 1),
        }
        if (self.op_types == OpKind.SCAN).any():
            out["p99_scan_ms"] = round(self.p99_scan * 1e3, 3)
            out["p999_scan_ms"] = round(self.p999_scan * 1e3, 3)
        if self.stats is not None:
            out.update(self.stats.summary())
        return out

    def per_shard_summary(self) -> list[dict]:
        """Per-shard latency/stall breakdown (fleet runs only; a single
        tree returns one row covering every op).  The cross-shard
        interference signal reads directly off these rows: the hot
        shard's stall seconds against every shard's inflated read tail."""
        if self.shard_ids is None:
            shard_ids = np.zeros(self.latency.shape[0], np.int64)
        else:
            shard_ids = self.shard_ids
        # every shard gets a row, including trailing shards no op routed to
        n_shards = max(self.n_shards,
                       int(shard_ids.max()) + 1 if shard_ids.size else 1)
        rows = []
        for s in range(n_shards):
            m = shard_ids == s
            lat = self.latency[m]
            kinds = self.op_types[m]
            stalls = [d for i, d in self.stall_events
                      if shard_ids[i] == s]
            row = {
                "shard": s,
                "ops": int(m.sum()),
                "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3)
                if lat.size else 0.0,
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)
                if lat.size else 0.0,
                "p999_ms": round(float(np.percentile(lat, 99.9)) * 1e3, 3)
                if lat.size else 0.0,
                "stall_total_s": round(sum(stalls), 4),
                "n_stalls": len(stalls),
            }
            g = lat[kinds == OpKind.GET]
            if g.size:
                row["p99_get_ms"] = round(float(np.percentile(g, 99)) * 1e3, 3)
            rows.append(row)
        return rows


@dataclass
class _RunState:
    """Everything :meth:`Simulator._setup` derives from an op stream before
    any engine-specific event processing starts (shared by the heap loop
    and the fleet engine)."""

    n: int
    op_types: np.ndarray
    keys: np.ndarray
    arrivals: np.ndarray
    scan_lens: np.ndarray
    service: np.ndarray
    get_reads: np.ndarray
    get_probed: np.ndarray
    block_t: float
    shard_ids: np.ndarray
    regions: np.ndarray
    ev_by_shard: list[list[tuple[int, int]]]
    shard_pos: list[np.ndarray]


class SlotPool:
    """Background executor: earliest-free-slot scheduling with job deps and
    per-(region, source-level) exclusivity.

    ``sanitizer`` (``REPRO_SANITIZE=1``) audits every assignment it makes
    — chain edges honoured, no double-occupied (tree, level) slot — at
    the cost of one ``None`` check per job otherwise.
    """

    def __init__(self, n_slots: int, sanitizer=None):
        self.free_at = [0.0] * max(1, n_slots)
        self.level_free: dict[tuple[int, int], float] = {}
        self.sanitizer = sanitizer

    def schedule(self, job: Job, ready: float, duration: float,
                 region: int = 0) -> None:
        dep_ready = max((d.t_finish for d in job.deps), default=0.0)
        lkey = (region, job.level)
        start = max(ready, dep_ready, self.level_free.get(lkey, 0.0))
        slot = min(range(len(self.free_at)), key=lambda i: self.free_at[i])
        start = max(start, self.free_at[slot])
        job.t_start = start
        job.t_finish = start + duration
        job.scheduled = True
        self.free_at[slot] = job.t_finish
        self.level_free[lkey] = job.t_finish
        if self.sanitizer is not None:
            self.sanitizer.on_schedule(region, job)


class ChainScheduler(SlotPool):
    """Chain-aware priority scheduler for the compaction pool.

    A drained batch of compaction jobs is grouped by ``chain_id`` and the
    chains are ordered by head urgency before slot assignment: chains
    whose head relieves L0 pressure go first (RocksDB's low-pri pool
    boosts L0->L1 work for exactly this reason), background soft-limit
    sweeps last; the policy object's ``chain_priority`` hook supplies the
    sort key.  Independent chains still run concurrently — priority only
    decides who gets the earliest free slot — while intra-chain
    dependency edges stay serialized via ``parent_job.t_finish`` (parents
    are always scheduled before their children because emission order
    within a chain is dependency order).
    """

    @staticmethod
    def rank_batch(jobs_durs: list[tuple[Job, float]],
                   priority_fn) -> list[tuple[Job, float]]:
        """Order one drained batch for slot assignment.
        ``priority_fn(chain_jobs)`` maps a chain's jobs (emission order,
        head last) to a sortable urgency key — lower schedules earlier;
        ties keep emission (FIFO) order.  Pure function of the jobs: the
        fleet engine ranks each batch once and replays the order across
        temporal passes."""
        order: list[int] = []
        groups: dict[int, list[tuple[Job, float]]] = {}
        for job, dur in jobs_durs:
            if job.chain_id not in groups:
                groups[job.chain_id] = []
                order.append(job.chain_id)
            groups[job.chain_id].append((job, dur))
        ranked = sorted(order,
                        key=lambda cid: priority_fn([j for j, _ in
                                                     groups[cid]]))
        return [jd for cid in ranked for jd in groups[cid]]

    def schedule_seq(self, ranked: list[tuple[Job, float]],
                     ready: float, region: int) -> None:
        """Assign slots to an already-ranked sequence."""
        for job, dur in ranked:
            self.schedule(job, ready, dur, region)

    def schedule_batch(self, jobs_durs: list[tuple[Job, float]],
                       ready: float, region: int, priority_fn) -> None:
        """Rank one drained batch by chain urgency, then assign slots."""
        self.schedule_seq(self.rank_batch(jobs_durs, priority_fn),
                          ready, region)


class Simulator:
    """The DES: per-shard foreground queues over one shared device.

    ``cfg.n_shards == 1`` is the classic engine — one foreground queue,
    optionally ``n_regions`` trees behind it (the paper's Fig 10 region
    experiment) — and stays byte-identical to the pre-sharding code.
    ``cfg.n_shards > 1`` partitions the keyspace (``ShardRouter``) over
    per-shard trees, each with its own queue/memtable/stall state, all
    sharing the flush slot and the chain-aware compaction pool.
    """

    def __init__(self, cfg: LSMConfig, device: DeviceModel | None = None,
                 n_regions: int = 1, uids: UidNamespace | None = None,
                 compute_device: str | torch.device = "cuda"):
        self.cfg = cfg
        # ``device`` is the storage model; the trees' arrays and the final
        # Lindley pass live on the torch ``compute_device``.
        self.compute_device = resolve_compute_device(compute_device)
        # Engine-private uid streams (None = legacy module-global counters
        # + reset_uid_counters idiom); see repro_torch.core.uids.
        self.uids = uids
        # Stall gates (write-stop occupancy, write-buffer allowance) are the
        # compaction policy's call, not an enum branch.
        self.policy = get_policy(cfg.policy)
        self.device = device or DeviceModel()
        # Scan block accounting happens in the tree (cfg.block_size) while
        # scan service pricing happens here (device.block_size): keep the
        # two granularities from silently diverging.
        assert cfg.block_size == self.device.block_size, \
            "LSMConfig.block_size must match DeviceModel.block_size"
        self.n_shards = cfg.n_shards
        assert self.n_shards == 1 or n_regions == 1, \
            "regions subdivide a single-shard store; a sharded fleet " \
            "keeps one region per shard"
        self.n_regions = n_regions
        self.router = ShardRouter.from_config(cfg)
        # One Stats ledger per shard; n_shards == 1 keeps the legacy shape
        # (all region trees share THE Stats), a fleet gets a read-only
        # aggregate view over the per-shard ledgers.
        self.shard_stats = [Stats() for _ in range(self.n_shards)]
        self.stats: Stats | FleetStats = self.shard_stats[0] \
            if self.n_shards == 1 else FleetStats(self.shard_stats)
        # Flat shard-major tree list: trees[shard * n_regions + region].
        self.trees = [LSMTree(cfg, self.shard_stats[s], shard_id=s,
                              region_id=r, uids=uids,
                              compute_device=self.compute_device)
                      for s in range(self.n_shards)
                      for r in range(n_regions)]
        # Dedicated flush slot + shared compaction slots (RocksDB's
        # high-priority flush pool vs low-priority compaction pool) —
        # shared across ALL shards: the device doesn't grow with the
        # fleet, which is exactly the contention under study.
        # REPRO_SANITIZE=1: runtime schedule sanitizer (None when off)
        self.sanitizer = maybe_sanitizer()
        self.flush_pool = SlotPool(1, sanitizer=self.sanitizer)
        self.compact_pool = ChainScheduler(
            max(1, self.device.compaction_slots - 1),
            sanitizer=self.sanitizer)
        # temporal L0 occupancy per tree: [appear_t, clears_at,
        # clearing_chain_id] entries (chain_id -1 until consumed — used to
        # attribute write-stop stall time to the chain that clears it)
        n_trees = self.n_shards * n_regions
        self.l0_entries: list[list[list]] = [[] for _ in range(n_trees)]
        self.flush_inflight: list[list[float]] = [[] for _ in range(n_trees)]
        self.job_log: list[Job] = []
        self.stall_events: list[tuple[int, float]] = []  # (op_idx, duration)

    # ------------------------------------------------------------------
    def _job_duration(self, job: Job) -> float:
        d = self.device
        return (d.read_time(job.bytes_read, max(1, job.n_in_ssts))
                + d.write_time(job.bytes_written, max(1, job.n_out_ssts)))

    def _chain_key(self, chain_jobs: list[Job]):
        """Priority key for one chain (emission order, head last) — the
        policy object's ``chain_priority`` hook, fed the chain head."""
        return self.policy.chain_priority(self.cfg, chain_jobs[-1],
                                          chain_jobs)

    def _schedule_drained(self, tree: LSMTree, tree_idx: int,
                          t: float) -> None:
        self._schedule_jobs(tree.drain_jobs(), tree_idx, t)

    def _schedule_jobs(self, drained: list[Job], tree_idx: int,
                       t: float) -> None:
        # Compactions first (priority-ordered by chain urgency), then
        # flushes: a flush's only dep is a compaction chain head, so its
        # dep is always scheduled by the time the flush pool sees it.
        # tree_idx namespaces the per-(tree, level) exclusivity key: two
        # shards' L1 compactions are independent and may overlap.
        compacts = [(j, self._job_duration(j)) for j in drained
                    if j.kind == "compact"]
        if compacts:
            if self.cfg.chain_aware_sched:
                self.compact_pool.schedule_batch(compacts, t, tree_idx,
                                                 self._chain_key)
            else:
                for job, dur in compacts:     # legacy FIFO drain order
                    self.compact_pool.schedule(job, t, dur, tree_idx)
            for job, _dur in compacts:        # emission order, like drain
                if job.level == 0 and job.l0_consumed:
                    self._consume_l0(tree_idx, job.l0_consumed, job.t_finish,
                                     job.chain_id)
                self._note_scheduled(job)
                self.job_log.append(job)
        for job in drained:
            if job.kind != "flush":
                continue
            self.flush_pool.schedule(job, t, self._job_duration(job),
                                     tree_idx)
            self.flush_inflight[tree_idx].append(job.t_finish)
            if job.bytes_written > 0:
                # SST appears in L0 when the flush lands.
                self.l0_entries[tree_idx].append([job.t_finish, np.inf, -1])
            self.job_log.append(job)

    def _note_scheduled(self, job: Job) -> None:
        """Fill the chain ledger's temporal fields and (paranoid) validate
        the intra-chain dependency edge the scheduler just honoured."""
        rec = self.shard_stats[job.shard].chain_index.get(job.chain_id)
        if rec is not None:
            rec.t_start = min(rec.t_start, job.t_start)
            rec.t_finish = max(rec.t_finish, job.t_finish)
        if self.cfg.paranoid_checks and job.parent_job is not None:
            assert job.t_start >= job.parent_job.t_finish - 1e-9, \
                "chain child scheduled before its parent finished"

    def _consume_l0(self, tree_idx: int, k: int, clears_at: float,
                    chain_id: int = -1) -> None:
        pending = [e for e in self.l0_entries[tree_idx] if e[1] == np.inf]
        pending.sort(key=lambda e: e[0])
        for e in pending[:k]:
            e[1] = clears_at
            e[2] = chain_id

    def _l0_stall(self, tree_idx: int, t: float) -> tuple[float, int]:
        """Wait until temporal L0 occupancy drops below the stop limit.
        Returns ``(stall, chain_id)`` — the chain whose head clears the
        slot the queue waits for (-1 when unknown); the caller attributes
        the stall to that chain only when the L0 wait is the binding
        component of the fill event's delay."""
        if self.sanitizer is not None:
            self.sanitizer.on_gate(tree_idx, t)
        stop = self.policy.l0_stop_ssts(self.cfg)
        entries = self.l0_entries[tree_idx]
        # Per-tree event times are nondecreasing (global event heap), so an
        # SST cleared by now can never gate again: drop it for good rather
        # than re-filtering the full history every event.
        live = [e for e in entries if e[1] > t]
        if len(live) != len(entries):
            self.l0_entries[tree_idx] = live
        active = sorted((e[1], e[2]) for e in live if e[0] <= t)
        if len(active) < stop:
            return 0.0, -1
        k = len(active) - stop  # waiting for the (k+1)-th clear
        target, cid = active[k]
        if not np.isfinite(target):
            target = max(self.compact_pool.free_at)
            cid = -1
        return max(0.0, target - t), int(cid)

    def _wb_stall(self, tree_idx: int, t: float) -> float:
        """Write-buffer stall: previous flush still in flight."""
        if self.sanitizer is not None:
            self.sanitizer.on_gate(tree_idx, t)
        unfinished = sorted(f for f in self.flush_inflight[tree_idx] if f > t)
        self.flush_inflight[tree_idx] = unfinished  # finished never gate again
        allowed = self.policy.write_buffer_limit(self.cfg) - 1
        if len(unfinished) < allowed:
            return 0.0
        return unfinished[len(unfinished) - allowed] - t

    # ------------------------------------------------------------------
    def _setup(self, op_types: np.ndarray, keys: np.ndarray,
               arrivals: np.ndarray,
               scan_lens: np.ndarray | None) -> "_RunState":
        """Shared run prologue: validate/normalize the op stream, price the
        base per-kind service, route ops to shards/regions and derive the
        fill-event schedule.  Both engines — the heap loop here and the
        two-phase :class:`repro_torch.core.fleet.FleetEngine` — start from
        the exact same :class:`_RunState`."""
        with span("des.setup"):
            n = op_types.shape[0]
            assert keys.shape[0] == n and arrivals.shape[0] == n and n > 0
            cfg = self.cfg
            kpm = cfg.keys_per_memtable
            op_types = np.ascontiguousarray(op_types, np.uint8)
            if scan_lens is None:
                assert not (op_types == OpKind.SCAN).any(), \
                    "SCAN ops require scan_lens"
                scan_lens = np.zeros(n, np.int32)
            scan_lens = np.ascontiguousarray(scan_lens, np.int32)
            service = np.full(n, PUT_SERVICE)
            service[op_types == OpKind.GET] = GET_CPU
            service[op_types == OpKind.SCAN] = SCAN_CPU
            get_reads = np.zeros(n, dtype=np.int32)
            get_probed = np.zeros(n, dtype=np.int32)
            block_t = (self.device.io_latency
                       + self.device.block_size / self.device.read_bw)

            # Columnar routing: shard (hash/range partition of the keyspace),
            # then region within the (single) shard.  tree = flat shard-major.
            shard_ids = self.router.shard_of(keys) if self.n_shards > 1 \
                else np.zeros(n, np.int64)
            regions = (keys % self.n_regions).astype(np.int64) \
                if self.n_regions > 1 else np.zeros(n, np.int64)
            tree_ids = shard_ids * self.n_regions + regions
            write_mask = (op_types == OpKind.PUT) | (op_types == OpKind.DELETE)
            write_idx = np.nonzero(write_mask)[0]

            # Fill-event schedule: the op index at which each tree's memtable
            # fills = every kpm-th write (PUT or DELETE) routed to that tree.
            fill_events: list[tuple[int, int]] = []  # (op_idx, tree_idx)
            for ti in range(len(self.trees)):
                t_writes = write_idx[tree_ids[write_idx] == ti]
                marks = t_writes[kpm - 1::kpm]
                fill_events.extend((int(m), ti) for m in marks)
            fill_events.sort()
            ev_by_shard: list[list[tuple[int, int]]] = \
                [[] for _ in range(self.n_shards)]
            for op_i, ti in fill_events:
                ev_by_shard[ti // self.n_regions].append((op_i, ti))
            shard_pos = [np.arange(n)] if self.n_shards == 1 else \
                [np.nonzero(shard_ids == s)[0] for s in range(self.n_shards)]
            return _RunState(n=n, op_types=op_types, keys=keys,
                             arrivals=arrivals, scan_lens=scan_lens,
                             service=service, get_reads=get_reads,
                             get_probed=get_probed, block_t=block_t,
                             shard_ids=shard_ids, regions=regions,
                             ev_by_shard=ev_by_shard, shard_pos=shard_pos)

    def _busy_inflation(self, st: "_RunState") -> None:
        """Read service refinement: device busy while compactions run
        (vectorized post-pass over the scheduled job log)."""
        with span("des.inflation"):
            service, arrivals, op_types = st.service, st.arrivals, st.op_types
            get_reads, block_t = st.get_reads, st.block_t
            # Only read kinds are inflated — compute overlap counts at their
            # arrivals alone (a temporal-pass hot path in the fleet engine).
            is_get = op_types == OpKind.GET
            is_scan = op_types == OpKind.SCAN
            ridx = np.nonzero(is_get | is_scan)[0]
            if ridx.size == 0:
                return
            starts = np.sort(np.array([j.t_start for j in self.job_log
                                       if j.kind == "compact"],
                                      dtype=np.float64))
            ends = np.sort(np.array([j.t_finish for j in self.job_log
                                     if j.kind == "compact"],
                                    dtype=np.float64))
            if starts.size == 0:
                return
            a_r = arrivals[ridx]
            busy_r = (np.searchsorted(starts, a_r, side="right")
                      - np.searchsorted(ends, a_r, side="right"))
            get_r = is_get[ridx]
            gi = ridx[get_r]
            service[gi] += (get_reads[gi] * block_t
                            * (BUSY_ALPHA * busy_r[get_r]))
            if is_scan.any():
                seq_block_t = self.device.block_size / self.device.read_bw
                si = ridx[~get_r]
                service[si] += (get_reads[si] * seq_block_t
                                * (BUSY_ALPHA * busy_r[~get_r]))

    def _make_result(self, st: "_RunState", latency: np.ndarray,
                     makespan: float,
                     stall_events: list[tuple[int, float]] | None = None,
                     job_log: list[Job] | None = None,
                     arrivals: np.ndarray | None = None,
                     chain_counts: list[int] | None = None,
                     chain_stall_s: list[float] | None = None) -> SimResult:
        """Assemble the result.  The overrides exist for the fleet engine,
        whose temporal passes each snapshot their own stall/job ledgers and
        arrival stream while sharing one engine (and its Stats)."""
        if stall_events is None:
            stall_events = self.stall_events
        if job_log is None:
            job_log = self.job_log
        if arrivals is None:
            arrivals = st.arrivals
        if chain_counts is None:
            chain_counts = [len(s.chains) for s in self.shard_stats]
        if chain_stall_s is None:
            chain_stall_s = [sum(c.stall_s for c in s.chains)
                             for s in self.shard_stats]
        stalls = np.array([d for _i, d in stall_events]) \
            if stall_events else np.zeros(0)
        return SimResult(
            arrivals=arrivals, latency=latency, op_types=st.op_types,
            stall_total=float(stalls.sum()),
            stall_max=float(stalls.max()) if stalls.size else 0.0,
            n_stalls=int(stalls.size), stats=self.stats,
            job_log=job_log, makespan=makespan,
            get_reads=st.get_reads, get_probed=st.get_probed,
            shard_ids=st.shard_ids if self.n_shards > 1 else None,
            n_shards=self.n_shards,
            stall_events=stall_events,
            chain_counts=chain_counts,
            chain_stall_s=chain_stall_s,
        )

    def run(self, op_types: np.ndarray, keys: np.ndarray,
            arrivals: np.ndarray,
            scan_lens: np.ndarray | None = None) -> SimResult:
        """Drive the store with a typed op stream (OpKind values).

        ``scan_lens[i]`` is the requested key count of a SCAN op (ignored
        for other kinds; may be omitted for scan-free streams).  Per-kind
        service: PUT/DELETE constant CPU, GET CPU + block reads × device,
        SCAN CPU + per-file seek + blocks spanned × sequential read — all
        read kinds get the same busy-inflation post-pass.
        """
        with span("des.run"):
            st = self._setup(op_types, keys, arrivals, scan_lens)
            n = st.n
            op_types, keys, arrivals = st.op_types, st.keys, st.arrivals
            scan_lens, service = st.scan_lens, st.service
            get_reads, get_probed = st.get_reads, st.get_probed
            block_t, regions = st.block_t, st.regions
            ev_by_shard, shard_pos = st.ev_by_shard, st.shard_pos

            # Per-shard processed clocks: D[s] = departure time of shard s's
            # most recently serviced op (exact Lindley per queue, maintained
            # incrementally per window); cur[s] = the shard's op cursor into
            # its own arrival sub-sequence.  Events are processed in
            # SIMULATED-TIME order: each shard's next fill time depends only
            # on its own queue, so one event per shard is staged (advancing
            # that shard's clock) and a heap pops the globally earliest —
            # shared-slot scheduling then sees chronological ready times, so
            # a lagging shard's backlogged jobs cannot phantom-block another
            # shard's earlier device work.  (op_i tiebreak: deterministic.)
            D = [0.0] * self.n_shards
            cur = [0] * self.n_shards
            ptrs = [0] * self.n_shards
            heap: list[tuple[float, int, int, int]] = []

            def stage(s: int) -> None:
                """Advance shard s's clock to its next fill event (applying
                the window structurally) and stage the event for dispatch."""
                if ptrs[s] >= len(ev_by_shard[s]):
                    return
                op_i, ti = ev_by_shard[s][ptrs[s]]
                pos = shard_pos[s]
                upper = int(np.searchsorted(pos, op_i, side="right"))
                D[s] = self._advance_clock(s, D[s], pos[cur[s]:upper],
                                           op_types, keys, scan_lens, regions,
                                           get_reads, get_probed, service,
                                           arrivals, block_t)
                cur[s] = upper
                heapq.heappush(heap, (D[s], op_i, s, ti))

            for s in range(self.n_shards):
                stage(s)
            while heap:
                t, op_i, s, ti = heapq.heappop(heap)
                with span("des.fill"):
                    if self.sanitizer is not None:
                        self.sanitizer.on_event(ti, t)
                    # t = D[s]: the fill happens when its last write is
                    # serviced
                    tree = self.trees[ti]
                    tree.seal_memtable()
                    stall = self._wb_stall(ti, t)
                    tree.flush_immutable()
                    self._schedule_drained(tree, ti, t)
                    bg = tree.background_triggers()
                    if bg:
                        self._schedule_drained(tree, ti, t)
                    l0_stall, cid = self._l0_stall(ti, t)
                    if l0_stall > stall and cid >= 0:
                        # the L0 wait is the binding delay: pin it on the
                        # chain whose head clears the awaited slot (the
                        # shard's ledger)
                        rec = self.shard_stats[s].chain_index.get(cid)
                        if rec is not None:
                            rec.stall_s += l0_stall
                    stall = max(stall, l0_stall)
                if stall > 0:
                    service[op_i] += stall
                    D[s] += stall
                    self.stall_events.append((op_i, stall))
                ptrs[s] += 1
                stage(s)
            for s in range(self.n_shards):
                self._advance_clock(s, D[s], shard_pos[s][cur[s]:], op_types,
                                    keys, scan_lens, regions, get_reads,
                                    get_probed, service, arrivals, block_t)

            # --- read service refinement: device busy while compactions run
            self._busy_inflation(st)

            # --- exact Lindley over each shard's FIFO queue ----------------
            # ONE ragged batch (a CSR row per shard) through the lindley_scan
            # kernel; on the CPU its plain version is the reference's numpy
            # recursion, bit for bit.
            with span("des.lindley"):
                order = np.concatenate(shard_pos)
                offsets = np.zeros(self.n_shards + 1, np.int64)
                np.cumsum([pos.shape[0] for pos in shard_pos],
                          out=offsets[1:])
                arr = arrivals[order].astype(np.float64)
                queues = torch.from_numpy(np.stack([service[order], arr])).to(
                    self.compute_device)
                departures = lindley_batch(queues[0], queues[1],
                                           offsets).cpu().numpy()
            latency = np.zeros(n, np.float64)
            latency[order] = departures - arr
            ends = offsets[1:][offsets[1:] > offsets[:-1]] - 1
            makespan = float(departures[ends].max()) if ends.size else 0.0
            return self._make_result(st, latency, makespan)

    def serve(self, spec, *, load_factor: float = 1.0):
        """Drive the store from a ``TrafficSpec`` (open-loop serving).

        The serving layer (``repro_torch.serving.traffic``) materializes
        the spec's tenants into one interleaved arrival schedule, runs the
        admission pre-pass, and feeds the admitted stream through
        :meth:`run` — so ``FleetEngine`` inherits this entry point and
        both engines accept the same spec.  With admission disabled the
        result is identical to :meth:`run` on the materialized arrays (the
        closed↔open parity gate).  Returns a ``ServeResult`` (per-tenant
        ledgers, goodput, SLO accounting).
        """
        # function-scoped: serving sits above core in the layer order
        from ..serving.traffic import serve as _serve
        return _serve(self, spec, load_factor=load_factor)

    # ------------------------------------------------------------------
    def _advance_clock(self, shard: int, D: float, idx: np.ndarray,
                       op_types, keys, scan_lens, regions, get_reads,
                       get_probed, service, arrivals,
                       block_t: float) -> float:
        """Apply shard ``shard``'s ops at global indices ``idx`` (its next
        arrival-order window) structurally and advance its processed clock.

        Returns the departure time of the window's last op (before any
        stall injection).  Each region's window slice becomes ONE typed
        ``RequestBatch`` through ``LSMTree.apply_batch`` (writes land
        first, then the window's GETs/SCANs observe constant tree state —
        trees are independent, so per-tree application equals global
        writes-then-reads order).  Read service includes the base
        device-read cost here; the busy-inflation term is refined in a
        vectorized post-pass.
        """
        if idx.shape[0] == 0:
            return D
        with span("des.window"):
            wsum, wmax = self._advance_window(shard, idx, op_types, keys,
                                              scan_lens, regions, get_reads,
                                              get_probed, service, arrivals,
                                              block_t)
        return wsum + max(D, wmax)

    def _advance_window(self, shard: int, idx: np.ndarray,
                        op_types, keys, scan_lens, regions, get_reads,
                        get_probed, service, arrivals,
                        block_t: float) -> tuple[float, float]:
        """The structural body of :meth:`_advance_clock`: apply the window
        to the shard's trees, charge read service, and return the window's
        Lindley aggregates ``(wsum, wmax)`` — total service and
        ``max_k(a_k - S_{k-1})`` — from which ANY carried-in clock advances
        as ``D' = wsum + max(D, wmax)``.  The fleet engine records these
        per window in its structural phase so its temporal phase replays
        clock advances in O(1) per event."""
        self._apply_window(shard, idx, op_types, keys, scan_lens, regions,
                           get_reads, get_probed, service, block_t)
        # incremental Lindley: D_j = S_j + max(D_prev, max_k(a_k - S_{k-1}))
        s = service[idx].astype(np.float64)
        s_cum = np.cumsum(s)
        a = arrivals[idx].astype(np.float64)
        shifted = np.empty_like(s_cum)
        shifted[0] = 0.0
        shifted[1:] = s_cum[:-1]
        return float(s_cum[-1]), float(np.max(a - shifted))

    def _apply_window(self, shard: int, idx: np.ndarray,
                      op_types, keys, scan_lens, regions, get_reads,
                      get_probed, service, block_t: float) -> None:
        """Arrival-independent half of :meth:`_advance_window`: apply the
        window's ops to the shard's trees and charge base read service.
        Windows are op-index-defined and stall injection only ever touches
        the last op of an already-aggregated window, so everything here —
        tree evolution, ``service`` base values, read counters — is the
        same for every arrival stream over the same op stream.  The fleet
        engine exploits exactly that: one structural replay amortized over
        a whole arrival-rate axis."""
        w_types = op_types[idx]
        w_keys = keys[idx]
        w_lens = scan_lens[idx]
        w_regions = regions[idx]
        stats = self.shard_stats[shard]
        tree_base = shard * self.n_regions
        scan_delivered = np.zeros(w_types.shape[0], np.int64)
        has_reads = bool(((w_types == OpKind.GET)
                          | (w_types == OpKind.SCAN)).any())
        for r in range(self.n_regions):
            rm = w_regions == r if self.n_regions > 1 \
                else np.ones(w_types.shape[0], bool)
            if not rm.any():
                continue
            ri = np.nonzero(rm)[0]
            if not has_reads:
                # Write-only window (the fillrandom hot path): skip the
                # batch machinery, same array-order semantics.
                self.trees[tree_base + r]._write_batch(
                    w_keys[ri], w_types[ri] == OpKind.DELETE)
                continue
            res = self.trees[tree_base + r].apply_batch(
                RequestBatch(w_types[ri], w_keys[ri], w_lens[ri]))
            is_get = res.kinds == OpKind.GET
            is_scan = res.kinds == OpKind.SCAN
            if is_get.any() or is_scan.any():
                rd = np.nonzero(is_get | is_scan)[0]
                get_reads[idx[ri[rd]]] = res.reads[rd]
                get_probed[idx[ri[rd]]] = res.probed[rd]
            if is_get.any():
                stats.device_reads += int(res.reads[is_get].sum())
                stats.ops += int(is_get.sum())
            if is_scan.any():
                sc = np.nonzero(is_scan)[0]
                scan_delivered[ri[sc]] = res.seqs[sc]
                stats.scan_blocks += int(res.reads[is_scan].sum())
                stats.scan_ops += int(is_scan.sum())
                stats.ops += int(is_scan.sum())
        g_idx = idx[w_types == OpKind.GET]
        service[g_idx] += get_reads[g_idx] * block_t
        w_sc = np.nonzero(w_types == OpKind.SCAN)[0]
        if w_sc.shape[0]:
            s_idx = idx[w_sc]
            # Modern-iterator latency model: the per-level/per-L0-file
            # seeks are issued CONCURRENTLY (RocksDB async_io-style, NVMe
            # queue depth), so a scan pays ONE seek wave of io_latency,
            # then streams its delivered bytes at sequential bandwidth,
            # plus a small per-file iterator CPU term.  The per-file block
            # traffic (get_reads) still hits the device — it feeds busy
            # inflation and Stats.scan_blocks — but it is not serialized
            # into foreground latency.
            delivered = scan_delivered[w_sc] * float(self.cfg.kv_size)
            service[s_idx] += (self.device.io_latency
                               + delivered / self.device.read_bw
                               + get_probed[s_idx] * SCAN_FILE_CPU)
