"""The DES's timing, worked out again in NumPy from the op stream, the
device model and the structure of the compactions.

What the simulator times, as its model states it: ops arrive at fixed
times into one FIFO queue; a PUT costs ``PUT_SERVICE`` of CPU, a GET
``GET_CPU`` plus one device block read for each block its lookup read.
A memtable fills at every ``keys_per_memtable``-th write, at the moment
that write departs the queue.  There the filled memtable is flushed to L0
and the compactions it sets off are scheduled: flushes on one slot,
compactions on ``compaction_slots - 1`` slots, each job at the earliest
free slot, after its chain parent (or, for a flush, the compaction that
clears L0 for it) has finished and after the last job from the same
level; in each batch of jobs the chains are ranked by the policy's
urgency first.  A job lasts its bytes at the device's rates plus one I/O
latency a file each way.  The fill stalls the queue until the previous
flush is done (a write-buffer stall) or until L0 holds fewer SSTs than
the stop limit, each flushed SST holding its place from its flush's end
to the end of the compaction that consumes it.  A GET's reads are slowed
by ``BUSY_ALPHA`` for each compaction running when it arrives.  The
queue is solved in closed form, ``D_i = C_i + max_{j <= i}(a_j -
C_{j-1})`` with ``C`` the running sum of service, ``lat_i = D_i - a_i``.

This module takes from the program only what it decided about structure:
which jobs each fill made, their levels, bytes, files, chains and parent
edges, and how many L0 SSTs a compaction consumed (the ledger,
``SimResult.job_log`` and ``Stats.chain_index``).  From them it works out
again every fill's time, every job's start and finish, every stall and
every op's latency, in one precision throughout.

A GET's reads are judged apart (:func:`read_faults`): whether its key's
latest version is in the memtable follows from the op stream alone, so a
GET must read no block and probe no SST when it is, and when it is not,
read its one true block and at most one more for each other SST it
probed (a bloom false positive).  Which SSTs a lookup probed, and which
of them gave a false positive, is the program's own state (the SSTs'
identities): the reference follows it there (``get_probed``) and takes
the program's read counts into the service of the ops.
"""

from __future__ import annotations

import numpy as np

PUT, GET = 0, 1
PUT_SERVICE = 1.5e-6       # s of CPU a put
GET_CPU = 2.0e-6           # s of CPU a get before its device reads
BUSY_ALPHA = 0.6           # read inflation a running compaction adds


def block_time(device: dict) -> float:
    return device["io_latency"] + device["block_size"] / device["read_bw"]


def fill_ops(kinds: np.ndarray, keys_per_memtable: int) -> np.ndarray:
    """The op index of every memtable fill: each ``keys_per_memtable``-th
    write of a single-tree store."""
    writes = np.nonzero(kinds == PUT)[0]
    return writes[keys_per_memtable - 1::keys_per_memtable]


def memtable_hits(kinds: np.ndarray, key_idx: np.ndarray,
                  fills: np.ndarray) -> np.ndarray:
    """For every GET of the stream (in stream order), whether its key's
    latest version is in the memtable when it is served: a window runs
    from the op after one fill to the next fill, its writes land first,
    and its GETs observe them; every fill flushes the memtable."""
    n = kinds.shape[0]
    g_pos = np.nonzero(kinds == GET)[0]
    out = np.zeros(g_pos.shape[0], bool)
    if g_pos.shape[0] == 0:
        return out
    g_win = np.searchsorted(fills, g_pos, side="left")
    bounds = np.concatenate([[-1], fills, [n - 1]]) + 1
    mark = np.zeros(int(key_idx.max()) + 1, bool)
    for w in np.unique(g_win):
        lo, hi = bounds[w], bounds[w + 1]
        puts = key_idx[lo:hi][kinds[lo:hi] == PUT]
        mark[puts] = True
        sel = g_win == w
        out[sel] = mark[key_idx[g_pos[sel]]]
        mark[puts] = False
    return out


def read_faults(kinds: np.ndarray, hits_mem: np.ndarray,
                get_reads: np.ndarray, get_probed: np.ndarray) -> int:
    """GETs whose read count breaks the lookup's rule (every key of the
    stream is in the store, so a GET not answered by the memtable reads
    its one true block)."""
    g = kinds == GET
    r = np.asarray(get_reads)[g].astype(np.int64)
    p = np.asarray(get_probed)[g].astype(np.int64)
    bad_mem = hits_mem & ((r != 0) | (p != 0))
    bad_sst = ~hits_mem & ((r < 1) | (r > p))
    return int(np.count_nonzero(bad_mem | bad_sst))


class _Pool:
    """Earliest-free-slot scheduling with parent edges and one job at a
    time from each source level."""

    def __init__(self, n_slots: int, rnd):
        self.free_at = [0.0] * max(1, n_slots)
        self.level_free: dict[int, float] = {}
        self.rnd = rnd

    def schedule(self, level: int, ready: float, dep_ready: float,
                 duration: float) -> tuple[float, float]:
        start = max(ready, dep_ready, self.level_free.get(level, 0.0))
        slot = min(range(len(self.free_at)), key=lambda i: self.free_at[i])
        start = max(start, self.free_at[slot])
        finish = self.rnd(start + duration)
        self.free_at[slot] = finish
        self.level_free[level] = finish
        return start, finish


def _events(ledger: dict) -> list[tuple[list[int], list[int]]]:
    """The ledger's jobs (indices in emission order) grouped by the fill
    that made them: (the flush-triggered chains and the flush, the
    background chains that followed it)."""
    events: list[tuple[list[int], list[int]]] = []
    pending: list[int] = []
    for i in range(ledger["flush"].shape[0]):
        if ledger["flush"][i]:
            events.append((pending + [i], []))
            pending = []
        elif ledger["l0_chain"][i]:
            pending.append(i)
        else:
            events[-1][1].append(i)
    assert not pending, "a flush-triggered chain after the last flush"
    return events


def _rank(jobs: list[int], ledger: dict, policy: str) -> list[int]:
    """A drained batch's compactions, chains ranked by the policy's
    urgency (lower first, ties in emission order): chains with an L0
    stage first; vlsm then the chain of fewest bytes."""
    order: list[int] = []
    groups: dict[int, list[int]] = {}
    for j in jobs:
        cid = int(ledger["chain_id"][j])
        if cid not in groups:
            groups[cid] = []
            order.append(cid)
        groups[cid].append(j)

    def key(cid):
        js = groups[cid]
        tier = 0 if any(ledger["level"][j] == 0 for j in js) else 1
        if policy == "vlsm":
            return (tier, sum(int(ledger["bytes_read"][j])
                              + int(ledger["bytes_written"][j]) for j in js))
        return (tier, 0)
    return [j for cid in sorted(order, key=key) for j in groups[cid]]


def timeline(kinds: np.ndarray, arrivals: np.ndarray, get_reads: np.ndarray,
             fills: np.ndarray, ledger: dict, lsm: dict, device: dict,
             policy: str, dtype=np.float64) -> dict:
    """Every fill's stall, every job's start and finish and every op's
    latency, each time held in ``dtype``."""
    rnd = (lambda x: float(np.float32(x))) if dtype == np.float32 \
        else (lambda x: x)
    n = kinds.shape[0]
    is_get = kinds == GET
    bt = block_time(device)
    service = np.full(n, PUT_SERVICE)
    service[is_get] = GET_CPU
    g_idx = np.nonzero(is_get)[0]
    service[g_idx] += get_reads[g_idx] * bt
    if dtype == np.float32:
        service = service.astype(np.float32).astype(np.float64)
    lat_io = device["io_latency"]

    def duration(j):
        return rnd((ledger["bytes_read"][j] / device["read_bw"]
                    + max(1, ledger["n_in"][j]) * lat_io)
                   + (ledger["bytes_written"][j] / device["write_bw"]
                      + max(1, ledger["n_out"][j]) * lat_io))

    n_jobs = ledger["flush"].shape[0]
    start = np.zeros(n_jobs)
    finish = np.zeros(n_jobs)
    flush_pool = _Pool(1, rnd)
    compact_pool = _Pool(device["compaction_slots"] - 1, rnd)
    l0: list[list[float]] = []          # [appears, clears] per L0 SST
    inflight: list[float] = []          # finish of every flush
    stop = lsm["l0_stop_ssts"]
    allowed = lsm["max_write_buffers"] - 1

    def dep_ready(j):
        d = ledger["dep"][j]
        return finish[d] if d >= 0 else 0.0

    def schedule(jobs: list[int], t: float) -> None:
        compacts = [j for j in jobs if not ledger["flush"][j]]
        if compacts:
            ranked = _rank(compacts, ledger, policy) \
                if lsm["chain_aware_sched"] else compacts
            for j in ranked:
                start[j], finish[j] = compact_pool.schedule(
                    int(ledger["level"][j]), t, dep_ready(j), duration(j))
            for j in compacts:
                k = int(ledger["l0_consumed"][j])
                if ledger["level"][j] == 0 and k:
                    pending = sorted((e for e in l0 if e[1] == np.inf),
                                     key=lambda e: e[0])
                    for e in pending[:k]:
                        e[1] = finish[j]
        for j in jobs:
            if not ledger["flush"][j]:
                continue
            start[j], finish[j] = flush_pool.schedule(
                -1, t, dep_ready(j), duration(j))
            inflight.append(finish[j])
            if ledger["bytes_written"][j] > 0:
                l0.append([finish[j], np.inf])

    events = _events(ledger)
    assert len(events) == fills.shape[0], \
        f"{len(events)} flushes in the ledger, {fills.shape[0]} fills"
    stalls = np.zeros(fills.shape[0])
    clock, cur = 0.0, 0
    for e, (f, (drain1, drain2)) in enumerate(zip(fills.tolist(), events)):
        s = service[cur:f + 1]
        s_cum = np.cumsum(s)
        shifted = np.empty_like(s_cum)
        shifted[0] = 0.0
        shifted[1:] = s_cum[:-1]
        wmax = float(np.max(arrivals[cur:f + 1] - shifted))
        clock = rnd(float(s_cum[-1]) + max(clock, wmax))
        t = clock
        unfinished = sorted(x for x in inflight if x > t)
        inflight[:] = unfinished
        wb = 0.0 if len(unfinished) < allowed \
            else rnd(unfinished[len(unfinished) - allowed] - t)
        schedule(drain1, t)
        schedule(drain2, t)
        l0[:] = [x for x in l0 if x[1] > t]
        active = sorted(x[1] for x in l0 if x[0] <= t)
        stall_l0 = 0.0
        if len(active) >= stop:
            target = active[len(active) - stop]
            if not np.isfinite(target):
                target = max(compact_pool.free_at)
            stall_l0 = max(0.0, rnd(target - t))
        stall = max(wb, stall_l0)
        if stall > 0:
            stalls[e] = stall
            service[f] += stall
            clock = rnd(clock + stall)
        cur = f + 1

    compact = ~ledger["flush"]
    starts = np.sort(start[compact])
    ends = np.sort(finish[compact])
    a_g = arrivals[g_idx]
    busy = (np.searchsorted(starts, a_g, side="right")
            - np.searchsorted(ends, a_g, side="right"))
    service[g_idx] += get_reads[g_idx] * bt * (BUSY_ALPHA * busy)
    one = dtype
    a = arrivals.astype(one)
    c = np.cumsum(service.astype(one), dtype=one)
    before = np.concatenate([np.zeros(1, one), c[:-1]])
    departures = c + np.maximum.accumulate(a - before)
    return {"latency": (departures - a).astype(np.float64),
            "stalls": stalls, "start": start, "finish": finish}
