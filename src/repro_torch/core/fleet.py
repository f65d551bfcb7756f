"""Two-phase fleet engine: structural replay once, O(1) clock advances per
arrival schedule, and one batched Lindley pass for a whole sweep matrix.

:class:`repro_torch.core.sim.Simulator` advances every shard's processed
clock inside its event heap: each staged fill event runs the shard's next
op window through the store (``apply_batch``) *and* folds the window into
the Lindley recursion, so structural replay, clock arithmetic and slot
scheduling are interleaved in one Python loop.  That loop is exact but
serial — a policy × config × shard-count × arrival-rate sweep pays it
once per matrix point.

This module splits the engine around two observations:

1. A window's effect on the clock is fully captured by two scalars.  With
   ``S`` the window's service prefix-sum and ``a`` its arrivals,

       D' = wsum + max(D, wmax),   wsum = S[-1],  wmax = max_k(a_k - S[k-1])

   for ANY carried-in clock ``D`` (associativity of the max-plus scan).
2. The structural evolution of a tree is **arrival-independent**: windows
   are op-index-defined (every ``keys_per_memtable``-th write), stall
   injection only ever touches the last op of an already-aggregated
   window, and SST/bloom identity is engine-order-independent (per-tree
   uid allocators).  The same op stream therefore produces identical
   trees, read counters and base service under every arrival schedule.

Hence the engine runs in phases:

* :meth:`FleetEngine.prepare_structural` — replay each tree's windows in
  shard order: all ``apply_batch`` / flush / compaction-emission work (the
  store's merges and rank probes on the compute device), recording per
  window the service prefix (``shifted``), the total ``wsum`` and the
  drained job batches.  Paid ONCE per op stream.
* :meth:`FleetEngine.temporal_pass` — for one arrival schedule, derive
  every window's ``wmax`` with a single ``np.maximum.reduceat`` (exact:
  max is associative) and run the *same* event heap as the serial engine
  — write-buffer/L0 stall gates, chain-aware slot scheduling, stall
  injection — with every clock advance O(1) from the recorded aggregates.
  Host-side control, repeatable over one replay.
* **Final latency** is the lindley_scan kernel over every pending shard
  queue (:func:`repro_torch.kernels.lindley_scan.ops.lindley_batch_np`:
  one CSR buffer, one launch).  On the card :func:`fleet_sweep` stacks the
  queues of EVERY (point, rate, shard) into that one call, so the whole
  matrix's latency accounting is a single kernel launch; on the CPU it
  streams one call per pass.

The serial engine stays the correctness oracle (:func:`serial_sweep`).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.lindley_scan.ops import lindley_batch_np
from .lsm import Job
from .sim import ChainScheduler, SimResult, Simulator, SlotPool
from .types import DeviceModel, LSMConfig
from .uids import reset_uid_counters

__all__ = ["FleetEngine", "PendingRun", "SweepPoint", "fleet_sweep",
           "reset_uid_counters", "serial_sweep", "traffic_curve"]


@dataclass
class _ShardPlan:
    """Phase-A record for one shard: everything its temporal passes need
    to advance the clock without re-touching the store."""

    starts: np.ndarray   # window start offsets into the shard's op order
    wsum: np.ndarray     # per-window total service (float64)
    shifted: np.ndarray  # per-op within-window service prefix S_{k-1}
    tail: int            # shard-local index where the trailing (clockless)
                         # window begins == end of the last fill window
    pos_tail: np.ndarray  # shard_pos[:tail] (the window-covered op indices)


@dataclass
class PendingRun:
    """One temporal pass awaiting its final batched Lindley evaluation.

    Snapshots the pass-local ledgers (several passes share one engine):
    ``queues`` are the per-shard ``(service, arrivals)`` pairs to scan,
    and ``stall_events`` / ``job_log`` feed the :class:`SimResult` that
    :meth:`FleetEngine.finalize` assembles from the departure times.
    """

    queues: list[tuple[np.ndarray, np.ndarray]]
    arrivals: np.ndarray
    stall_events: list[tuple[int, float]] = field(default_factory=list)
    job_log: list[Job] = field(default_factory=list)
    # per-shard chain-ledger snapshot at pass end (the shared Stats only
    # keep the most recent pass's temporal fields)
    chain_counts: list[int] = field(default_factory=list)
    chain_stall_s: list[float] = field(default_factory=list)


class FleetEngine(Simulator):
    """Two-phase (structural replay + O(1)-advance temporal heap) engine.

    Drop-in for :class:`Simulator`: same constructor (``compute_device``
    included), same :meth:`run` contract, same :class:`SimResult`.  The
    phase boundary is public — ``prepare_structural`` once,
    ``temporal_pass`` per arrival schedule, ``finalize`` per pass — so
    :func:`fleet_sweep` can amortize the structural replay over a rate
    axis and batch every pending Lindley pass into one kernel launch.

    Caveat: the engine owns ONE set of Stats ledgers.  Structural counters
    (I/O amp, chain shapes, vSST quality) are arrival-independent and valid
    for every pass; the chain ledger's *temporal* fields (``t_start``/
    ``t_finish``/``stall_s``) are reset each :meth:`temporal_pass` and
    therefore reflect the **most recent** pass only.
    """

    def prepare_structural(self, op_types: np.ndarray, keys: np.ndarray,
                           scan_lens: np.ndarray | None = None) -> None:
        """Phase A: replay every shard's op windows through the store and
        record the per-window Lindley aggregates + drained job batches."""
        n = op_types.shape[0]
        st = self._setup(op_types, keys, np.zeros(n, np.float64), scan_lens)
        self._st = st
        self._plans: list[_ShardPlan] = []
        # batches[s][k]: shard s's k-th fill event's drained job batches
        # (post-flush drain, then post-background-trigger drain), each
        # pre-ranked for slot assignment — durations and chain-priority
        # order are pure functions of the jobs, so they are computed HERE
        # once instead of inside every temporal pass.
        self._batches: list[list[list[tuple]]] = []
        for s in range(self.n_shards):
            pos = st.shard_pos[s]
            m = pos.shape[0]
            n_ev = len(st.ev_by_shard[s])
            starts = np.empty(n_ev, np.int64)
            wsums = np.empty(n_ev, np.float64)
            shifted = np.zeros(m, np.float64)
            b: list[list[tuple]] = []
            cur = 0
            for k, (op_i, ti) in enumerate(st.ev_by_shard[s]):
                upper = int(np.searchsorted(pos, op_i, side="right"))
                idx = pos[cur:upper]
                self._apply_window(s, idx, st.op_types, st.keys,
                                   st.scan_lens, st.regions, st.get_reads,
                                   st.get_probed, st.service, st.block_t)
                svc = st.service[idx].astype(np.float64)
                s_cum = np.cumsum(svc)
                shifted[cur] = 0.0
                shifted[cur + 1:upper] = s_cum[:-1]
                starts[k] = cur
                wsums[k] = s_cum[-1]
                cur = upper
                tree = self.trees[ti]
                tree.seal_memtable()
                tree.flush_immutable()
                first = tree.drain_jobs()
                second = tree.drain_jobs() \
                    if tree.background_triggers() else []
                plans = [self._plan_batch(first)]
                if second:
                    plans.append(self._plan_batch(second))
                b.append(plans)
            if cur < m:
                # trailing window past the last fill event: structural
                # effects (read service) only, no clock consumer
                self._apply_window(s, pos[cur:], st.op_types, st.keys,
                                   st.scan_lens, st.regions, st.get_reads,
                                   st.get_probed, st.service, st.block_t)
            self._plans.append(_ShardPlan(starts, wsums, shifted, cur,
                                          pos[:cur]))
            self._batches.append(b)
        # Base per-op service after structural replay (device reads
        # charged, no stalls, no busy inflation): the reset point every
        # temporal pass starts from.
        self._service0 = st.service.copy()
        # Pass-scratch service buffer: temporal passes rewind into it, and
        # only the gathered per-shard queues escape a pass.
        self._svc_buf = np.empty_like(self._service0)

    def _plan_batch(self, drained: list[Job]) -> tuple:
        """Precompute the arrival-independent half of ``_schedule_jobs``
        for one drained batch: per-job durations, the chain-priority slot
        order (``ChainScheduler.rank_batch`` — pure in the jobs), and the
        flush/L0 bookkeeping flags.  Temporal passes replay the plan."""
        compacts = [(j, self._job_duration(j)) for j in drained
                    if j.kind == "compact"]
        if self.cfg.chain_aware_sched:
            ranked = ChainScheduler.rank_batch(compacts, self._chain_key)
        else:
            ranked = compacts              # legacy FIFO drain order
        flushes = [(j, self._job_duration(j), j.bytes_written > 0)
                   for j in drained if j.kind == "flush"]
        return ranked, [j for j, _ in compacts], flushes

    def _schedule_planned(self, plan: tuple, tree_idx: int,
                          t: float) -> None:
        """``_schedule_jobs`` with the structural half precomputed: slot
        assignment, L0 consumption and the ledgers — identical ordering
        and timestamps to the serial engine's path."""
        ranked, compacts, flushes = plan
        if compacts:
            self.compact_pool.schedule_seq(ranked, t, tree_idx)
            log = self.job_log
            for job in compacts:           # emission order, like drain
                if job.level == 0 and job.l0_consumed:
                    self._consume_l0(tree_idx, job.l0_consumed,
                                     job.t_finish, job.chain_id)
                self._note_scheduled(job)
                log.append(job)
        for job, dur, lands_sst in flushes:
            self.flush_pool.schedule(job, t, dur, tree_idx)
            self.flush_inflight[tree_idx].append(job.t_finish)
            if lands_sst:
                self.l0_entries[tree_idx].append([job.t_finish, np.inf, -1])
            self.job_log.append(job)

    def temporal_pass(self, arrivals: np.ndarray) -> PendingRun:
        """Phase B for one arrival schedule: the serial engine's event
        heap — identical ordering, stall gates and slot scheduling — with
        O(1) clock advances from the phase-A aggregates.  Returns the
        pass's pending shard queues + ledgers; call repeatedly with
        different schedules to sweep a rate axis over one replay."""
        st = self._st
        arrivals = np.asarray(arrivals, np.float64)
        assert arrivals.shape[0] == st.n
        st.arrivals = arrivals
        np.copyto(self._svc_buf, self._service0)
        st.service = service = self._svc_buf
        # pass-local temporal state (device pools, L0 occupancy, ledgers)
        n_trees = self.n_shards * self.n_regions
        self.l0_entries = [[] for _ in range(n_trees)]
        self.flush_inflight = [[] for _ in range(n_trees)]
        if self.sanitizer is not None:
            self.sanitizer.reset()    # each pass is its own timeline
        self.flush_pool = SlotPool(1, sanitizer=self.sanitizer)
        self.compact_pool = ChainScheduler(
            max(1, self.device.compaction_slots - 1),
            sanitizer=self.sanitizer)
        self.job_log = []
        self.stall_events = []
        for stats in self.shard_stats:
            for rec in stats.chains:
                rec.t_start = math.inf
                rec.t_finish = 0.0
                rec.stall_s = 0.0

        # Every window's wmax for THIS schedule, one reduceat per shard.
        # Exact: the reduction is a plain max over the same
        # ``a_k - S_{k-1}`` values the serial engine maxes per window.
        wmaxes: list[np.ndarray] = []
        for s in range(self.n_shards):
            plan = self._plans[s]
            if plan.starts.size:
                gaps = arrivals[plan.pos_tail] - plan.shifted[:plan.tail]
                wmaxes.append(np.maximum.reduceat(gaps, plan.starts))
            else:
                wmaxes.append(np.empty(0, np.float64))

        # Identical event ordering and stall/scheduling logic to
        # Simulator.run; the only difference is that _advance_clock's
        # structural work already happened, leaving wsum/wmax lookups.
        D = [0.0] * self.n_shards
        ptrs = [0] * self.n_shards
        heap: list[tuple[float, int, int, int]] = []

        def stage(s: int) -> None:
            k = ptrs[s]
            if k >= len(st.ev_by_shard[s]):
                return
            op_i, ti = st.ev_by_shard[s][k]
            D[s] = float(self._plans[s].wsum[k]) \
                + max(D[s], float(wmaxes[s][k]))
            heapq.heappush(heap, (D[s], op_i, s, ti))

        for s in range(self.n_shards):
            stage(s)
        while heap:
            t, op_i, s, ti = heapq.heappop(heap)
            if self.sanitizer is not None:
                self.sanitizer.on_event(ti, t)
            stall = self._wb_stall(ti, t)
            for plan in self._batches[s][ptrs[s]]:
                self._schedule_planned(plan, ti, t)
            l0_stall, cid = self._l0_stall(ti, t)
            if l0_stall > stall and cid >= 0:
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

        self._busy_inflation(st)
        pending = PendingRun(
            queues=[(service[p], arrivals[p]) for p in st.shard_pos],
            arrivals=arrivals,
            stall_events=self.stall_events,
            job_log=self.job_log,
            chain_counts=[len(s.chains) for s in self.shard_stats],
            chain_stall_s=[sum(c.stall_s for c in s.chains)
                           for s in self.shard_stats])
        self._pending = pending
        return pending

    def run_prepare(self, op_types: np.ndarray, keys: np.ndarray,
                    arrivals: np.ndarray,
                    scan_lens: np.ndarray | None = None
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Phases A and B for a single schedule; returns the per-shard
        ``(service, arrivals)`` queues awaiting their Lindley pass."""
        self.prepare_structural(op_types, keys, scan_lens)
        return self.temporal_pass(arrivals).queues

    def lindley(self, pending: PendingRun) -> list[np.ndarray]:
        """One pass's departures: its shard queues through the
        lindley_scan kernel in one call on the engine's compute device."""
        return lindley_batch_np([q[0] for q in pending.queues],
                                [q[1] for q in pending.queues],
                                compute_device=self.compute_device)

    def finalize(self, departures: list[np.ndarray],
                 pending: PendingRun | None = None) -> SimResult:
        """Assemble the :class:`SimResult` from per-shard departure times
        (one array per queue of ``pending``; defaults to the most recent
        temporal pass)."""
        if pending is None:
            pending = self._pending
        st = self._st
        # np.empty is safe: shard_pos partitions every op, so each index
        # is written exactly once; queues already hold the gathered
        # per-shard arrivals, saving a second gather here.
        latency = np.empty(st.n, np.float64)
        makespan = 0.0
        for pos, (_svc, arr_q), dep in zip(st.shard_pos, pending.queues,
                                           departures):
            if pos.shape[0] == 0:
                continue
            latency[pos] = dep - arr_q
            makespan = max(makespan, float(dep[-1]))
        return self._make_result(st, latency, makespan,
                                 stall_events=pending.stall_events,
                                 job_log=pending.job_log,
                                 arrivals=pending.arrivals,
                                 chain_counts=pending.chain_counts,
                                 chain_stall_s=pending.chain_stall_s)

    def run(self, op_types: np.ndarray, keys: np.ndarray,
            arrivals: np.ndarray,
            scan_lens: np.ndarray | None = None) -> SimResult:
        """Full two-phase run; the final Lindley pass is the lindley_scan
        kernel on the card, its plain version on the CPU."""
        self.run_prepare(op_types, keys, arrivals, scan_lens)
        return self.finalize(self.lindley(self._pending))


def traffic_curve(eng: FleetEngine, op_types: np.ndarray,
                  keys: np.ndarray, scan_lens: np.ndarray | None,
                  arrival_grid: list[np.ndarray]) -> list[SimResult]:
    """An offered-load axis over ONE structural replay.

    A load curve scales every tenant's rate by a common factor, which
    compresses the arrival schedule but leaves the op stream (and hence
    store structure) invariant — exactly the amortization the two-phase
    split buys: phase A once, one temporal pass + Lindley finalize per
    factor.  ``eng`` must be freshly constructed (callers pair this with
    ``reset_uid_counters``); per-pass results share its Stats like
    ``fleet_sweep`` points do.
    """
    eng.prepare_structural(op_types, keys, scan_lens)
    out: list[SimResult] = []
    for arr in arrival_grid:
        pd = eng.temporal_pass(arr)
        out.append(eng.finalize(eng.lindley(pd), pending=pd))
    return out


@dataclass
class SweepPoint:
    """One matrix point: a store configuration plus the op stream to
    drive it with.  ``label`` tags the result rows (e.g. "vlsm/4").
    Supply either one ``arrivals`` schedule or an ``arrivals_grid`` —
    a whole rate axis evaluated over a single structural replay.
    """

    label: str
    cfg: LSMConfig
    device: DeviceModel
    op_types: np.ndarray
    keys: np.ndarray
    arrivals: np.ndarray | None = None
    scan_lens: np.ndarray | None = None
    n_regions: int = 1
    arrivals_grid: list[np.ndarray] | None = None

    @property
    def grid(self) -> list[np.ndarray]:
        if self.arrivals_grid is not None:
            return self.arrivals_grid
        assert self.arrivals is not None, \
            f"SweepPoint {self.label!r} needs arrivals or arrivals_grid"
        return [self.arrivals]


def fleet_sweep(points: list[SweepPoint],
                compute_device: str | torch.device = "cuda"
                ) -> list[list[SimResult]]:
    """Evaluate a policy × config × shard × rate matrix.

    Each point gets its own :class:`FleetEngine` (independent store
    state) and ONE structural replay; each schedule in its ``grid`` is a
    temporal pass over that replay.  On the card every pending shard queue
    of every (point, rate) is then stacked into ONE ``lindley_batch_np``
    call — the whole matrix's latency accounting is a single lindley_scan
    launch.  On the CPU the plain version scans row by row anyway, so the
    Lindley pass and finalize stream per pass instead (same results,
    without holding every pending queue of the matrix alive at once).

    Returns one ``list[SimResult]`` per point, aligned with its grid.
    Per point, the results share the engine's Stats: structural counters
    hold for every rate, chain *temporal* fields reflect the last pass.
    """
    stacked = torch.device(compute_device).type == "cuda"
    engines: list[FleetEngine] = []
    pendings: list[list[PendingRun]] = []
    spans: list[list[tuple[int, int]]] = []
    services: list[np.ndarray] = []
    arrival_qs: list[np.ndarray] = []
    out: list[list[SimResult]] = []
    for p in points:
        reset_uid_counters()
        eng = FleetEngine(p.cfg, p.device, n_regions=p.n_regions,
                          compute_device=compute_device)
        eng.prepare_structural(p.op_types, p.keys, p.scan_lens)
        if not stacked:
            rows: list[SimResult] = []
            for arr in p.grid:
                pd = eng.temporal_pass(arr)
                rows.append(eng.finalize(eng.lindley(pd), pending=pd))
            out.append(rows)
            continue
        pds: list[PendingRun] = []
        sps: list[tuple[int, int]] = []
        for arr in p.grid:
            pd = eng.temporal_pass(arr)
            sps.append((len(services), len(services) + len(pd.queues)))
            services.extend(q[0] for q in pd.queues)
            arrival_qs.extend(q[1] for q in pd.queues)
            pds.append(pd)
        engines.append(eng)
        pendings.append(pds)
        spans.append(sps)
    if not stacked:
        return out
    deps = lindley_batch_np(services, arrival_qs,
                            compute_device=compute_device)
    return [[eng.finalize(deps[a:b], pending=pd)
             for pd, (a, b) in zip(pds, sps)]
            for eng, pds, sps in zip(engines, pendings, spans)]


def serial_sweep(points: list[SweepPoint],
                 compute_device: str | torch.device = "cuda"
                 ) -> list[list[SimResult]]:
    """Heap-loop oracle over the same matrix: one serial
    :class:`Simulator` run per (point, rate) — the full structural replay
    every time.  The parity baseline for :func:`fleet_sweep` and the
    denominator of its reported speedup."""
    out: list[list[SimResult]] = []
    for p in points:
        rows: list[SimResult] = []
        for arr in p.grid:
            reset_uid_counters()
            sim = Simulator(p.cfg, p.device, n_regions=p.n_regions,
                            compute_device=compute_device)
            rows.append(sim.run(p.op_types, p.keys, arr, p.scan_lens))
        out.append(rows)
    return out
