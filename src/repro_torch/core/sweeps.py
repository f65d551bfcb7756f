"""Parallel sweep executor + content-addressed structural-replay cache.

A sweep matrix is a list of :class:`~repro_torch.core.fleet.SweepPoint`\\ s;
the two-phase fleet engine already amortizes the expensive structural
replay (phase A) over each point's arrival grid.  This layer adds the two
remaining amortizations:

* **Across processes** — :func:`sweep_execute` dispatches points over a
  worker pool.  The pool uses the ``spawn`` start method: CUDA does not
  survive a ``fork`` once the parent has touched the card, so every
  worker is a fresh interpreter that loads the already built kernel
  libraries (``build/repro_torch/``) and gets the points ONCE, through
  the pool's initializer; a task is a plain index into them.  Every engine
  is built with its own :class:`~repro_torch.core.uids.UidNamespace`, so
  worker interleaving cannot perturb any uid stream, and the rows of any
  worker count are identical.
* **Across calls** — :class:`StructuralCache` stores PREPARED engines
  (phase A done) under a content address: blake2b over the canonicalized
  ``LSMConfig`` (policy name included), the ``DeviceModel``, the region
  count and the raw op-stream bytes.  A hit skips phase A entirely and
  goes straight to ``temporal_pass`` + Lindley — sound because a temporal
  pass resets ALL pass-local state, so a cached engine returns the exact
  :class:`~repro_torch.core.fleet.PendingRun` a fresh replay would.
  Arrival schedules are deliberately NOT part of the key: structure is
  arrival-independent — that independence is the amortization.

Every :func:`run_point` call reports per-phase wall-clock
(:class:`PointTiming`) so the bench rows carry the win, and the module
:data:`LEDGER` accumulates executor wall vs summed per-task compute for
db_bench's ``perf_trajectory`` row.  A spawned worker runs without the
cache (prepared engines hold device arrays, which do not cross
processes), so cache hits happen only in-process.
"""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .fleet import FleetEngine, SweepPoint
from .sim import SimResult, Simulator
from .uids import UidNamespace


# ------------------------------------------------------------- content key

def _digest_array(h, arr: np.ndarray | None) -> None:
    if arr is None:
        h.update(b"<none>")
        return
    a = np.ascontiguousarray(arr)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def point_key(point: SweepPoint) -> str:
    """Content address of a point's *structural* identity.

    Covers everything phase A depends on — the full canonicalized
    ``LSMConfig`` (policy name included), the device model, the region
    count and the op-stream arrays (types / keys / scan lens, raw bytes).
    Arrivals are excluded on purpose: the structural replay is
    arrival-independent, so every schedule shares the cached engine.
    ``blake2b`` rather than builtin ``hash``: stable across processes and
    runs.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(sorted(dataclasses.asdict(point.cfg).items())).encode())
    h.update(repr(sorted(dataclasses.asdict(point.device).items())).encode())
    h.update(str(int(point.n_regions)).encode())
    _digest_array(h, point.op_types)
    _digest_array(h, point.keys)
    _digest_array(h, point.scan_lens)
    return h.hexdigest()


# ------------------------------------------------------------------ cache

class StructuralCache:
    """Bounded LRU of prepared :class:`FleetEngine`\\ s, content-keyed.

    A ``get`` hit returns an engine whose phase A already ran for the
    exact (config, device, regions, op stream) content — safe to run
    ``temporal_pass`` on directly.  Entries hold the engine's full
    structural state (plans, pre-ranked batches, trees on the compute
    device), so the default capacity is small; eviction is LRU.
    """

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: OrderedDict[str, FleetEngine] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> FleetEngine | None:
        eng = self._entries.get(key)
        if eng is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return eng

    def put(self, key: str, eng: FleetEngine) -> None:
        self._entries[key] = eng
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def stats(self) -> dict:
        return {"size": len(self._entries), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses}


#: the process-default cache ``run_point`` callers may share
DEFAULT_CACHE = StructuralCache()


# ----------------------------------------------------------------- timing

@dataclass
class PointTiming:
    """Per-phase wall-clock of one executed point.

    ``structural_s`` is phase A (0.0 on a cache hit); the three lists
    are per-grid-schedule (temporal pass, Lindley scan, finalize).
    """

    label: str
    cache_hit: bool
    structural_s: float
    temporal_s: list[float] = field(default_factory=list)
    lindley_s: list[float] = field(default_factory=list)
    finalize_s: list[float] = field(default_factory=list)

    @property
    def total_s(self) -> float:
        """The point's whole compute (the serial-equivalent cost this
        task would contribute to a single-process run)."""
        return self.structural_s + sum(self.temporal_s) \
            + sum(self.lindley_s) + sum(self.finalize_s)

    def row(self, i: int) -> dict:
        """Phase-timing fragment for the point's i-th grid row.  Phase A
        is attributed to the first row only, so summing a point's rows
        never double-counts the shared structural replay."""
        return {
            "structural_s": round(self.structural_s if i == 0 else 0.0, 6),
            "temporal_s": round(self.temporal_s[i], 6),
            "lindley_s": round(self.lindley_s[i], 6),
            "finalize_s": round(self.finalize_s[i], 6),
            "cache_hit": bool(self.cache_hit),
        }


@dataclass
class ExecutorLedger:
    """Per-process running totals of executor activity.

    ``wall_s`` is executor wall-clock; ``task_s`` the summed per-task
    compute — what the same tasks would cost serially in one process —
    so ``speedup`` is the pool+cache win the ``perf_trajectory`` bench
    row records.
    """

    wall_s: float = 0.0
    task_s: float = 0.0
    tasks: int = 0
    cache_hits: int = 0
    cache_misses: int = 0

    def add(self, *, wall_s: float, timings: list[PointTiming]) -> None:
        self.wall_s += wall_s
        for t in timings:
            self.task_s += t.total_s
            self.tasks += 1
            if t.cache_hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    @property
    def speedup(self) -> float:
        return self.task_s / max(self.wall_s, 1e-9)

    def reset(self) -> None:
        self.wall_s = 0.0
        self.task_s = 0.0
        self.tasks = 0
        self.cache_hits = 0
        self.cache_misses = 0


#: accumulates across every sweep_execute / bench helper in the process
LEDGER = ExecutorLedger()


# -------------------------------------------------------------- run_point

def run_point(point: SweepPoint, *,
              compute_device: str | torch.device = "cuda",
              cache: StructuralCache | None = None
              ) -> tuple[list[SimResult], PointTiming]:
    """Evaluate one sweep point: phase A (or a cache hit), then one
    temporal pass + Lindley + finalize per schedule in ``point.grid``.

    The engine is built with a fresh :class:`UidNamespace`, making the
    results identical to the ``reset_uid_counters()`` + module-counter
    path regardless of what else the process has run.  Each pass's
    Lindley is one lindley_scan launch on the card.  ``lindley_s`` ends
    when the departures are back on the host.  Returns the per-schedule
    results and the point's :class:`PointTiming`.
    """
    key = point_key(point)
    eng = cache.get(key) if cache is not None else None
    hit = eng is not None
    structural = 0.0
    if eng is None:
        t0 = time.perf_counter()
        eng = FleetEngine(point.cfg, point.device,
                          n_regions=point.n_regions, uids=UidNamespace(),
                          compute_device=compute_device)
        eng.prepare_structural(point.op_types, point.keys, point.scan_lens)
        structural = time.perf_counter() - t0
        if cache is not None:
            cache.put(key, eng)
    timing = PointTiming(label=point.label, cache_hit=hit,
                         structural_s=structural)
    results: list[SimResult] = []
    for arr in point.grid:
        t0 = time.perf_counter()
        pd = eng.temporal_pass(arr)
        t1 = time.perf_counter()
        deps = eng.lindley(pd)
        t2 = time.perf_counter()
        results.append(eng.finalize(deps, pending=pd))
        t3 = time.perf_counter()
        timing.temporal_s.append(t1 - t0)
        timing.lindley_s.append(t2 - t1)
        timing.finalize_s.append(t3 - t2)
    return results, timing


# --------------------------------------------------------- spawn-pool map

# A worker's share of the sweep, set once per worker process by the pool's
# initializer: (points, compute_device); tasks are plain indices.
_WORKER: tuple | None = None


def _init_worker(points: list[SweepPoint], compute_device: str) -> None:
    global _WORKER
    _WORKER = (points, compute_device)


def _point_task(i: int) -> tuple[list[SimResult], PointTiming]:
    points, compute_device = _WORKER
    return run_point(points[i], compute_device=compute_device)


def _serial_run(p: SweepPoint, arrivals: np.ndarray,
                compute_device) -> SimResult:
    sim = Simulator(p.cfg, p.device, n_regions=p.n_regions,
                    uids=UidNamespace(), compute_device=compute_device)
    return sim.run(p.op_types, p.keys, arrivals, p.scan_lens)


def _serial_task(task: tuple[int, int]) -> SimResult:
    pi, ai = task
    points, compute_device = _WORKER
    return _serial_run(points[pi], points[pi].grid[ai], compute_device)


def _spawn_map(fn, tasks: list, workers: int, initargs=None) -> list:
    """``fn`` over ``tasks`` on a spawn pool (never fork: see the module
    docstring), order kept; ``initargs`` go to each worker's
    :func:`_init_worker` once."""
    ctx = multiprocessing.get_context("spawn")
    init = None if initargs is None else _init_worker
    with ctx.Pool(processes=min(workers, len(tasks)), initializer=init,
                  initargs=initargs or ()) as pool:
        return pool.map(fn, tasks)


def parallel_map(fn, items, *, workers: int = 1) -> list:
    """Order-preserving map with an optional spawn pool.

    ``fn`` must be a module-level callable and ``items`` picklable when
    ``workers > 1`` (standard ``multiprocessing`` contract); ``workers
    <= 1`` is a plain in-process loop with no pool, no pickling.
    """
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    return _spawn_map(fn, items, workers)


# -------------------------------------------------------------- executors

def sweep_execute(points: list[SweepPoint], *, workers: int = 1,
                  compute_device: str | torch.device = "cuda",
                  cache: StructuralCache | None = None
                  ) -> tuple[list[list[SimResult]], list[PointTiming]]:
    """Evaluate a sweep matrix through the executor.

    ``workers <= 1`` runs every point in-process (cache hits fully
    visible); ``workers > 1`` dispatches whole points over a spawn pool,
    whose workers run without the cache — deterministic regardless of
    scheduling because every engine draws from its own uid namespace.
    Returns ``(results, timings)`` with ``results[p]`` aligned to
    ``points[p].grid`` exactly like
    :func:`repro_torch.core.fleet.fleet_sweep`.
    """
    t0 = time.perf_counter()
    if workers <= 1 or len(points) <= 1:
        pairs = [run_point(p, compute_device=compute_device, cache=cache)
                 for p in points]
    else:
        pairs = _spawn_map(_point_task, list(range(len(points))), workers,
                           (list(points), str(torch.device(compute_device))))
    wall = time.perf_counter() - t0
    results = [r for r, _ in pairs]
    timings = [t for _, t in pairs]
    LEDGER.add(wall_s=wall, timings=timings)
    return results, timings


def serial_sweep_parallel(points: list[SweepPoint], *, workers: int = 1,
                          compute_device: str | torch.device = "cuda"
                          ) -> list[list[SimResult]]:
    """:func:`repro_torch.core.fleet.serial_sweep` (the heap-loop oracle,
    full structural replay per (point, rate)) with namespace-built engines
    and an optional spawn pool over the flattened (point, rate) tasks.
    Identical results to ``serial_sweep``, in the same per-point
    grouping."""
    tasks = [(pi, ai) for pi, p in enumerate(points)
             for ai in range(len(p.grid))]
    if workers <= 1 or len(tasks) <= 1:
        flat = [_serial_run(points[pi], points[pi].grid[ai], compute_device)
                for pi, ai in tasks]
    else:
        flat = _spawn_map(_serial_task, tasks, workers,
                          (list(points), str(torch.device(compute_device))))
    out: list[list[SimResult]] = []
    k = 0
    for p in points:
        n = len(p.grid)
        out.append(flat[k:k + n])
        k += n
    return out
