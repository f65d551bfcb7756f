"""Open-loop traffic layer over the per-shard Lindley queues.

Converts the engine from a replay tool into a service model: a
:class:`TrafficSpec` names a set of tenants — each a workload mix, an
offered rate, an arrival process, a priority and an SLO target — and
:func:`materialize` turns it into one deterministic op stream: seeded
per-tenant arrival processes (deterministic / Poisson / bursty via
superposed on-off sources), per-tenant key streams drawn from the YCSB
mix generators over a shared preloaded population, interleaved in
simulated-time order.  The engines consume that stream through their
existing window machinery (each fill window becomes one
``RequestBatch``), so with admission disabled the open loop is identical
to handing the same arrays to ``Simulator.run`` — the closed↔open parity
gate.

:func:`serve` drives either engine (``Simulator`` or ``FleetEngine``)
from a spec: admission verdicts (:mod:`repro.serving.admission`) are a
deterministic pre-pass (host-side control), the admitted stream runs
through the engine — the store's merges and ranks and the final Lindley
pass on the engine's ``compute_device`` — and per-tenant ledgers
(offered / shed / throttled / SLO violations, goodput) land in the
per-shard ``Stats`` so ``FleetStats`` aggregates them like every other
counter.  :func:`serve_grid` sweeps an offered-load axis: scaling every
tenant's rate by a common factor compresses simulated time uniformly and
preserves the interleave order, so the admission-off curve amortizes ONE
fleet structural replay across the whole axis (one temporal pass and one
lindley_scan launch per factor).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

import torch

from ..bench_kv.workloads import (load_keys, make_run_a, make_run_b,
                                  make_run_c, make_run_e)
from ..core.stats import TenantLedger
from ..core.types import OpKind

from .admission import ADMIT, SHED, THROTTLE, AdmissionConfig, admit

MIXES = ("load", "ycsb_a", "ycsb_b", "ycsb_c", "ycsb_e")
ARRIVALS = ("deterministic", "poisson", "bursty")


# ---------------------------------------------------------------- spec

@dataclass(frozen=True)
class TenantSpec:
    """One tenant: workload mix + offered rate + priority + SLO target.

    ``priority`` 0 is highest (shed last; below the admission floor it is
    never shed).  ``limit_ops_s`` arms a per-tenant token bucket
    (``burst_ops`` deep); ``None`` leaves the tenant unthrottled.  The
    bursty arrival process superposes ``n_sources`` on-off sources with
    exponential ON/OFF periods (means ``on_s`` / ``off_s``) emitting
    Poisson bursts while ON — heavier-tailed interarrivals than Poisson
    at the same mean rate (index-of-dispersion test in the traffic
    tests).
    """

    name: str
    rate_ops_s: float
    mix: str = "ycsb_a"              # one of MIXES
    arrival: str = "poisson"         # one of ARRIVALS
    priority: int = 1
    slo_ms: float = 50.0
    dist: str = "zipfian"            # key popularity over the population
    limit_ops_s: float | None = None
    burst_ops: float = 64.0
    n_sources: int = 4
    on_s: float = 0.2
    off_s: float = 0.8


@dataclass(frozen=True)
class TrafficSpec:
    """A reproducible multi-tenant open-loop scenario.

    ``population`` keys are preloaded (flood arrivals at
    ``load_rate_ops_s``), the store settles for ``settle_s``, then every
    tenant's stream runs for ``duration_s`` of simulated time.
    ``admission=None`` disables the controller (every op admitted) — the
    degenerate case the closed↔open parity gate pins.
    """

    tenants: tuple[TenantSpec, ...]
    duration_s: float
    seed: int = 7
    population: int = 20_000
    settle_s: float = 10.0
    load_rate_ops_s: float = 1e6
    admission: AdmissionConfig | None = None


@dataclass
class TrafficStream:
    """A materialized spec: the interleaved op stream plus provenance.

    ``tenant_ids[i]`` is the tenant index of op ``i`` (-1 for preload
    ops); ``tenant_seq[i]`` its position in that tenant's own generated
    sequence (the interleave-order invariant: per tenant, strictly
    increasing).  ``duration_s`` is the measured-phase simulated span
    (``spec.duration_s / load_factor``).
    """

    op_types: np.ndarray
    keys: np.ndarray
    arrivals: np.ndarray
    scan_lens: np.ndarray
    tenant_ids: np.ndarray
    tenant_seq: np.ndarray
    n_load: int
    t_run_start_s: float
    duration_s: float
    load_factor: float = 1.0

    @property
    def n_offered(self) -> int:
        """Offered traffic ops (preload excluded)."""
        return int(self.op_types.shape[0]) - self.n_load


# ---------------------------------------------------- arrival processes

def deterministic_arrivals(n: int, rate_ops_s: float) -> np.ndarray:
    """Fixed-interval offsets from 0: op i arrives at ``i / rate``."""
    return np.arange(n, dtype=np.float64) / rate_ops_s


def poisson_arrivals(n: int, rate_ops_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Poisson process offsets: i.i.d. exponential interarrivals."""
    return np.cumsum(rng.exponential(1.0 / rate_ops_s, size=n))


def bursty_arrivals(n: int, rate_ops_s: float, rng: np.random.Generator, *,
                    n_sources: int = 4, on_s: float = 0.2,
                    off_s: float = 0.8) -> np.ndarray:
    """Self-similar-ish offsets: superposed exponential on-off sources.

    Each source alternates OFF (mean ``off_s``) and ON (mean ``on_s``)
    periods and emits a Poisson burst while ON, at a rate chosen so the
    long-run aggregate matches ``rate_ops_s``.  The superposition's
    counting process is over-dispersed relative to Poisson (index of
    dispersion > 1) — the classic bursty-traffic construction.
    """
    duty = on_s / (on_s + off_s)
    src_rate_ops_s = rate_ops_s / (max(1, n_sources) * duty)
    chunks: list[np.ndarray] = []
    for quota in np.array_split(np.arange(n), max(1, n_sources)):
        need = int(quota.shape[0])
        got = 0
        t_s = rng.exponential(off_s)       # stagger: every source starts OFF
        while got < need:
            on = rng.exponential(on_s)
            k = min(int(rng.poisson(src_rate_ops_s * on)), need - got)
            if k:
                chunks.append(t_s + np.sort(rng.random(k)) * on)
                got += k
            t_s += on + rng.exponential(off_s)
    out = np.concatenate(chunks) if chunks else np.empty(0, np.float64)
    out.sort()
    return out


def _tenant_offsets(ten: TenantSpec, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    if ten.arrival == "deterministic":
        return deterministic_arrivals(n, ten.rate_ops_s)
    if ten.arrival == "poisson":
        return poisson_arrivals(n, ten.rate_ops_s, rng)
    if ten.arrival == "bursty":
        return bursty_arrivals(n, ten.rate_ops_s, rng,
                               n_sources=ten.n_sources, on_s=ten.on_s,
                               off_s=ten.off_s)
    raise ValueError(f"unknown arrival process {ten.arrival!r} "
                     f"(one of {ARRIVALS})")


def _tenant_mix(ten: TenantSpec, population: np.ndarray, n: int, seed: int):
    """(op_types, keys, scan_lens) for one tenant's measured stream."""
    if ten.mix == "load":
        return (np.zeros(n, np.uint8), load_keys(n, seed),
                np.zeros(n, np.int32))
    makers = {"ycsb_a": make_run_a, "ycsb_b": make_run_b,
              "ycsb_c": make_run_c, "ycsb_e": make_run_e}
    if ten.mix not in makers:
        raise ValueError(f"unknown mix {ten.mix!r} (one of {MIXES})")
    spec = makers[ten.mix](population, n, dist=ten.dist, seed=seed)
    lens = spec.scan_lens if spec.scan_lens is not None \
        else np.zeros(n, np.int32)
    return spec.op_types, spec.keys, lens


# ------------------------------------------------------------ materialize

def materialize(spec: TrafficSpec,
                load_factor: float = 1.0) -> TrafficStream:
    """Deterministically expand a spec into one interleaved op stream.

    ``load_factor`` scales every tenant's offered rate by a common
    multiplier by compressing the measured phase's simulated time
    (op counts and the interleave order are invariant along the axis —
    what lets ``serve_grid`` amortize one structural replay across it).
    """
    pop = np.unique(load_keys(spec.population, spec.seed))
    n_load = int(pop.shape[0])
    load_arrivals = np.arange(n_load, dtype=np.float64) / spec.load_rate_ops_s
    t0 = (load_arrivals[-1] if n_load else 0.0) + spec.settle_s
    ops_l, keys_l, lens_l, arr_l, tid_l, seq_l = [], [], [], [], [], []
    for ti, ten in enumerate(spec.tenants):
        n_t = max(1, int(round(ten.rate_ops_s * spec.duration_s)))
        rng = np.random.default_rng((spec.seed, ti))
        offsets = _tenant_offsets(ten, n_t, rng)
        ot, ky, ln = _tenant_mix(ten, pop, n_t,
                                 seed=spec.seed + 101 * (ti + 1))
        ops_l.append(ot)
        keys_l.append(ky)
        lens_l.append(ln)
        arr_l.append(t0 + offsets / load_factor)
        tid_l.append(np.full(n_t, ti, np.int32))
        seq_l.append(np.arange(n_t, dtype=np.int64))
    op_types = np.concatenate([np.zeros(n_load, np.uint8)] + ops_l)
    keys = np.concatenate([pop] + keys_l)
    scan_lens = np.concatenate([np.zeros(n_load, np.int32)] + lens_l)
    arrivals = np.concatenate([load_arrivals] + arr_l)
    tenant_ids = np.concatenate([np.full(n_load, -1, np.int32)] + tid_l)
    tenant_seq = np.concatenate([np.zeros(n_load, np.int64)] + seq_l)
    # simulated-time interleave; stable ⇒ per-tenant order survives ties
    order = np.argsort(arrivals, kind="stable")
    return TrafficStream(
        op_types=op_types[order], keys=keys[order],
        arrivals=arrivals[order], scan_lens=scan_lens[order],
        tenant_ids=tenant_ids[order], tenant_seq=tenant_seq[order],
        n_load=n_load, t_run_start_s=t0,
        duration_s=spec.duration_s / load_factor, load_factor=load_factor)


# ----------------------------------------------------------------- serve

@dataclass
class ServeResult:
    """One open-loop run: engine result + admission + tenant accounting.

    ``latency_full`` aligns with ``stream`` (NaN where an op was shed or
    throttled — those ops never reached the engine); ``tenants`` holds
    one global :class:`~repro_torch.core.stats.TenantLedger` per tenant (the
    per-shard splits live in the engine's ``Stats``).
    """

    res: object                      # SimResult of the admitted stream
    stream: TrafficStream
    verdicts: np.ndarray
    latency_full: np.ndarray
    tenants: list[TenantLedger]
    duration_s: float
    # executor phase-timing fragment for this run's bench row
    # (structural_s / temporal_s / lindley_s / finalize_s / cache_hit);
    # None when the caller didn't time the run
    timing: dict | None = None

    @property
    def offered_ops(self) -> int:
        return sum(t.ops_offered for t in self.tenants)

    @property
    def offered_ops_s(self) -> float:
        return self.offered_ops / max(self.duration_s, 1e-12)

    @property
    def goodput_ops_s(self) -> float:
        """Admitted ops that completed within their tenant's SLO, per
        second of measured simulated time."""
        good = sum(t.ops_admitted - t.slo_violations for t in self.tenants)
        return good / max(self.duration_s, 1e-12)

    @property
    def shed_frac(self) -> float:
        return sum(t.ops_shed for t in self.tenants) \
            / max(1, self.offered_ops)

    @property
    def throttled_frac(self) -> float:
        return sum(t.ops_throttled for t in self.tenants) \
            / max(1, self.offered_ops)

    @property
    def slo_violation_frac(self) -> float:
        adm = sum(t.ops_admitted for t in self.tenants)
        return sum(t.slo_violations for t in self.tenants) / max(1, adm)

    def tenant_latency(self, ti: int, op: int | None = None) -> np.ndarray:
        """Admitted-op latencies of tenant ``ti`` (optionally one kind)."""
        m = (self.stream.tenant_ids == ti) & (self.verdicts == ADMIT)
        if op is not None:
            m &= self.stream.op_types == op
        return self.latency_full[m]


def _ledger(ten: TenantSpec, mask: np.ndarray, verdicts: np.ndarray,
            latency_full: np.ndarray, slo_s: float) -> TenantLedger:
    v = verdicts[mask]
    lat = latency_full[mask][v == ADMIT]
    return TenantLedger(
        name=ten.name, priority=ten.priority, slo_ms=ten.slo_ms,
        ops_offered=int(mask.sum()),
        ops_admitted=int((v == ADMIT).sum()),
        ops_shed=int((v == SHED).sum()),
        ops_throttled=int((v == THROTTLE).sum()),
        slo_violations=int(np.count_nonzero(lat > slo_s)))


def _assemble(cfg, spec: TrafficSpec, stream: TrafficStream,
              verdicts: np.ndarray, shard_ids: np.ndarray, res,
              stats_sink=None, timing: dict | None = None) -> ServeResult:
    """Per-tenant accounting over one engine result.

    ``stats_sink`` (an engine, or None) receives the per-shard tenant
    ledger splits — None for grid passes, whose engine may live in the
    executor's structural cache rather than in the caller's hands.
    """
    n = int(stream.op_types.shape[0])
    latency_full = np.full(n, np.nan)
    latency_full[verdicts == ADMIT] = res.latency
    ledgers = []
    for ti, ten in enumerate(spec.tenants):
        slo_s = ten.slo_ms * 1e-3
        t_mask = stream.tenant_ids == ti
        ledgers.append(_ledger(ten, t_mask, verdicts, latency_full, slo_s))
        if stats_sink is not None:
            for s in range(stats_sink.n_shards):
                m = t_mask & (shard_ids == s)
                if not m.any():
                    continue
                led = _ledger(ten, m, verdicts, latency_full, slo_s)
                st = stats_sink.shard_stats[s]
                if ten.name in st.tenants:
                    st.tenants[ten.name].merge_from(led)
                else:
                    st.tenants[ten.name] = led
                st.ops_offered += led.ops_offered
                st.ops_shed += led.ops_shed
                st.ops_throttled += led.ops_throttled
                st.slo_violations += led.slo_violations
    if cfg.paranoid_checks:
        # conservation: every offered op got exactly one verdict
        for led in ledgers:
            assert led.ops_offered == (led.ops_admitted + led.ops_shed
                                       + led.ops_throttled), \
                f"tenant {led.name}: admission verdicts do not conserve " \
                f"offered ops ({led})"
        n_off = int((stream.tenant_ids >= 0).sum())
        assert sum(led.ops_offered for led in ledgers) == n_off, \
            "per-tenant offered counts do not cover the offered stream"
        assert int((verdicts[stream.tenant_ids < 0] != ADMIT).sum()) == 0, \
            "preload ops must bypass admission"
    return ServeResult(res=res, stream=stream, verdicts=verdicts,
                       latency_full=latency_full, tenants=ledgers,
                       duration_s=stream.duration_s, timing=timing)


def serve(sim, spec: TrafficSpec, *, load_factor: float = 1.0,
          record_stats: bool = True) -> ServeResult:
    """Drive an engine (``Simulator`` or ``FleetEngine``) from a spec.

    Admission (when configured) is a deterministic pre-pass over the
    offered stream, so both engines receive the same admitted stream and
    open-loop parity reduces to the existing engine parity.  With
    ``admission=None`` the engine sees the materialized arrays untouched
    — identical to the closed-loop ``run`` on the same stream.
    """
    stream = materialize(spec, load_factor=load_factor)
    shard_ids = sim.router.shard_of(stream.keys)
    if spec.admission is None:
        verdicts = np.zeros(stream.op_types.shape[0], np.uint8)
        res = sim.run(stream.op_types, stream.keys, stream.arrivals,
                      stream.scan_lens)
    else:
        verdicts = admit(stream.op_types, stream.arrivals,
                         stream.tenant_ids, shard_ids, spec.tenants,
                         spec.admission, sim.cfg, sim.device)
        keep = verdicts == ADMIT
        res = sim.run(stream.op_types[keep], stream.keys[keep],
                      stream.arrivals[keep], stream.scan_lens[keep])
    return _assemble(sim.cfg, spec, stream, verdicts, shard_ids, res,
                     stats_sink=sim if record_stats else None)


def _admitted_point(task) -> ServeResult:
    """One admission-on grid point: a fresh namespace-built serial
    engine on the task's compute device, timed end-to-end (ending once
    the latencies are on the host).  Module-level (spawn-pool pickling
    contract); the serial engine has no phase split, so the whole run
    lands in ``structural_s`` and the pass phases report 0.0."""
    import time
    from ..core.sim import Simulator
    from ..core.uids import UidNamespace
    cfg, device, spec, factor, compute_device = task
    t0 = time.perf_counter()
    sr = serve(Simulator(cfg, device, uids=UidNamespace(),
                         compute_device=compute_device), spec,
               load_factor=factor)
    wall = time.perf_counter() - t0
    sr.timing = {"structural_s": round(wall, 6), "temporal_s": 0.0,
                 "lindley_s": 0.0, "finalize_s": 0.0, "cache_hit": False}
    return sr


def serve_grid(cfg, device, spec: TrafficSpec,
               load_factors: tuple[float, ...], *,
               compute_device: str | torch.device = "cuda",
               workers: int = 1, cache=None) -> list[ServeResult]:
    """Sweep an offered-load axis: one :class:`ServeResult` per factor.

    Admission-off curves go through the sweep executor
    (:func:`repro_torch.core.sweeps.run_point`): ONE structural replay —
    or a :class:`~repro_torch.core.sweeps.StructuralCache` hit skipping
    it — then a temporal pass and one lindley_scan launch per factor (the
    op stream is factor-invariant; only arrivals compress).  With
    admission on, each factor's admitted subset differs, so each point
    runs a fresh serial engine — those points are independent and
    dispatch over the executor's spawn pool when ``workers > 1``.
    Engines are namespace-built either way, so results are identical at
    every worker count.  Grid passes keep
    per-pass tenant ledgers on the ``ServeResult`` only — single
    ``serve`` calls are the path that lands admission counters in
    ``Stats``.  Every result carries its phase-timing fragment in
    ``.timing``.
    """
    import time
    from ..core.fleet import SweepPoint
    from ..core.shard import ShardRouter
    from ..core.sweeps import LEDGER, PointTiming, parallel_map, run_point
    from ..core.types import resolve_compute_device
    compute_device = str(resolve_compute_device(compute_device))
    t_grid = time.perf_counter()
    if spec.admission is not None:
        tasks = [(cfg, device, spec, f, compute_device)
                 for f in load_factors]
        out = parallel_map(_admitted_point, tasks, workers=workers)
        timings = [PointTiming(label=f"{cfg.policy}/adm/{f}",
                               cache_hit=False,
                               structural_s=sr.timing["structural_s"])
                   for f, sr in zip(load_factors, out)]
        LEDGER.add(wall_s=time.perf_counter() - t_grid, timings=timings)
        return out
    streams = [materialize(spec, load_factor=f) for f in load_factors]
    base = streams[0]
    point = SweepPoint(label=f"{cfg.policy}/off", cfg=cfg, device=device,
                       op_types=base.op_types, keys=base.keys,
                       scan_lens=base.scan_lens,
                       arrivals_grid=[s.arrivals for s in streams])
    results, timing = run_point(point, compute_device=compute_device,
                                cache=cache)
    LEDGER.add(wall_s=time.perf_counter() - t_grid, timings=[timing])
    shard_ids = ShardRouter.from_config(cfg).shard_of(base.keys)
    verdicts = np.zeros(base.op_types.shape[0], np.uint8)
    return [_assemble(cfg, spec, stream, verdicts, shard_ids, res,
                      timing=timing.row(i))
            for i, (stream, res) in enumerate(zip(streams, results))]
