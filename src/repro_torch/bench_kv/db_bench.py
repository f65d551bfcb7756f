"""db_bench-style harness (paper §5: Meta-datacenter population runs), on
the compute device.

``fillrandom`` populates the store to a target level-fill (the paper fills
all levels but the last) under uniform or Pareto key popularity and
reports I/O amplification — the paper measures only amplification with
db_bench, as do we.  ``read_path`` is the read-side companion: a
read-heavy YCSB-C run that times the DES wall-clock end-to-end, tracking
the batched LevelIndex GET path.  ``ycsb_a`` measures mixed-workload
(50% read / 50% update) tails, ``seekrandom`` scan tails while a writer
streams, ``chain_report`` is the chain observatory — per-policy
compaction-chain width/length/critical-path distributions on the same
fillrandom stream (paper §3, Figs 2 & 9) — and ``shard_sweep`` drives the
sharded fleet: YCSB-A at a FIXED aggregate rate over 1/2/4 hash shards
contending for one device, plus a Zipf hot-shard scenario whose per-shard
breakdown shows one shard's chains soaking up the stall attribution while
every shard's read tail rides the same busy device.  ``fleet_sweep`` runs
the policy × shard-count × rate matrix through the sweep executor, timed
against the serial heap loop as its oracle, and ``serve_sweep`` drives the
pinned three-tenant open-loop scenario (``make_serve_spec``) over an
offered-load axis, admission off and on (``repro_torch.serving``).
``--bench name[,name...]`` restricts the sweep; the row schemas are the
reference's (``docs/benchmarks.md``).

Every bench runs the store on ``compute_device`` (``--compute-device``,
default ``cuda``: the merge_path, overlap_scan and lindley_scan kernels);
``cpu`` runs their plain versions.  Policies are resolved from the
registry; ``--policy name[,name...]`` restricts the sweep.  Two row keys
name a tier and carry the port's (the compute device's type):
``read_path``/``seekrandom``'s ``index_backend`` and the fleet summary's
``backend``.

``--json PATH`` writes the rows; by default nothing is written (the
committed ``BENCH_dbbench.json`` holds the reference's rows)::

    PYTHONPATH=src python -m repro_torch.bench_kv.db_bench --json out.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..core import (DEFAULT_CACHE, LEDGER, DeviceModel, LSMConfig, OpKind,
                    Simulator, SweepPoint, resolve_compute_device,
                    serial_sweep_parallel, sweep_execute)
from ..core.policies import get_policy, names as policy_names, \
    resolve_names
from .workloads import (load_keys, make_run_a, make_run_c, make_run_e,
                        pareto_keys)


def fill_sim(cfg: LSMConfig, n_ops: int, dist: str = "uniform",
             scale: int | None = None, seed: int = 7,
             compute_device: str | torch.device = "cuda"
             ) -> tuple[Simulator, "object", float]:
    """Shared fillrandom drive (flood arrivals): returns (sim, res, wall).

    ``fillrandom`` and ``chain_report`` both report off this; pass the
    triple to either via ``run=`` to derive both rows from ONE simulation
    instead of running the identical fill twice."""
    scale = scale or cfg.memtable_size
    lam = scale / (64 << 20)
    sim = Simulator(cfg, DeviceModel.scaled(lam),
                    compute_device=compute_device)
    base = load_keys(n_ops, seed)
    keys = base if dist == "uniform" else pareto_keys(base, n_ops, seed=seed)
    arrivals = np.arange(n_ops) / 1e6          # flood: amp-only measurement
    t0 = time.perf_counter()
    res = sim.run(np.zeros(n_ops, np.uint8), keys, arrivals)
    return sim, res, time.perf_counter() - t0


def fillrandom(cfg: LSMConfig, n_ops: int, *, dist: str = "uniform",
               scale: int | None = None, seed: int = 7, run=None,
               compute_device: str | torch.device = "cuda") -> dict:
    sim, res, wall = run or fill_sim(cfg, n_ops, dist, scale, seed,
                                     compute_device)
    st = res.stats
    return {
        "bench": "fillrandom", "dist": dist, "policy": cfg.policy,
        "ops": n_ops,
        "io_amp": round(st.io_amp, 2), "write_amp": round(st.write_amp, 2),
        "levels_filled": sum(1 for s in sim.trees[0].level_sizes() if s > 0),
        "compactions": sum(st.compactions_per_level.values()),
        "wall_clock_s": round(wall, 3),
    }


def chain_report(cfg: LSMConfig, n_ops: int, *, dist: str = "uniform",
                 scale: int | None = None, seed: int = 7, run=None,
                 compute_device: str | torch.device = "cuda") -> dict:
    """Chain observatory (paper §3, Figs 2 & 9): drive fillrandom and
    report the chain ledger's width/length/critical-path distributions.

    Width is the chain head's L0 fan-in (tiering designs merge all of L0
    at once — wide; incremental designs pop one SST — narrow, the paper's
    narrow-chain claim), length the levels a chain traverses, and
    ``effective_length`` folds in the debt catch-up that debt designs
    defer into background sweeps.  Critical path is the device wall-clock
    from the chain's first stage start to its head finish, as scheduled
    by the chain-aware DES pool; ``stall_attributed_s`` is the foreground
    write-stop time the DES pinned on each chain."""
    sim, res, wall = run or fill_sim(cfg, n_ops, dist, scale, seed,
                                     compute_device)
    row = {
        "bench": "chain_report", "workload": "fillrandom", "dist": dist,
        "policy": cfg.policy, "ops": n_ops,
    }
    row.update(res.chain_report())
    row["wall_clock_s"] = round(wall, 3)
    return row


def read_path(cfg: LSMConfig, n_ops: int = 200_000, n_pop: int = 100_000, *,
              scale: int | None = None, rate: float = 1e4,
              seed: int = 7,
              compute_device: str | torch.device = "cuda") -> dict:
    """Read-heavy YCSB-C probe (zipfian GETs over a preloaded store): the
    wall-clock of the whole DES run is the tracked quantity — it is
    dominated by the GET path, one ``LSMTree.get_batch`` (overlap_scan
    ranks on the compute device) per window."""
    scale = scale or cfg.memtable_size
    lam = scale / (64 << 20)
    pop = np.unique(load_keys(n_pop, seed))
    spec = make_run_c(pop, n_ops, dist="zipfian", seed=seed + 5)
    op_types = np.concatenate([np.zeros(pop.shape[0], np.uint8),
                               spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    arrivals = np.arange(op_types.shape[0], dtype=np.float64) / rate
    sim = Simulator(cfg, DeviceModel.scaled(lam),
                    compute_device=compute_device)
    t0 = time.perf_counter()
    res = sim.run(op_types, keys, arrivals)
    wall = time.perf_counter() - t0
    g = res.op_types == 1
    return {
        "bench": "read_path", "workload": "run_c",
        "policy": cfg.policy, "ops": n_ops,
        "wall_clock_s": round(wall, 3),
        "p99_get_ms": round(res.pct(99, op=1) * 1e3, 3),
        "p999_get_ms": round(res.pct(99.9, op=1) * 1e3, 3),
        "device_reads": int(sim.stats.device_reads),
        "mean_ssts_probed": round(float(res.get_probed[g].mean()), 3),
        "index_backend": sim.compute_device.type,
    }


def _load_settle_run(n_load: int, n_run: int, rate: float,
                     settle_s: float) -> tuple[np.ndarray, np.ndarray]:
    """Shared open-loop arrival scaffolding for the measured benches:
    load-phase flood (1M ops/s), a ``settle_s`` compaction settle (YCSB's
    wait between load and run), then the measured run at ``rate``."""
    load = np.arange(n_load, dtype=np.float64) / 1e6
    run = load[-1] + settle_s + np.arange(n_run, dtype=np.float64) / rate
    return load, run


def _run_phase_stalls(sim: Simulator, n_load: int) -> list[float]:
    """Stall durations of the measured phase only — the load flood stalls
    every policy by construction and would drown the signal.  Load ops
    arrive first, so run-phase ops are exactly the indices >= n_load."""
    return [d for i, d in sim.stall_events if i >= n_load]


def seekrandom(cfg: LSMConfig, n_ops: int = 40_000, n_pop: int = 60_000, *,
               scale: int | None = None, rate: float = 300.0,
               write_rate: float = 800.0, settle_s: float = 30.0,
               seed: int = 7,
               compute_device: str | torch.device = "cuda") -> dict:
    """Scan-tail probe: YCSB-E SCANs measured while a writer streams —
    db_bench's ``seekrandomwhilewriting`` counterpart.

    Methodology: load-phase flood, a ``settle_s`` compaction settle
    (YCSB's wait between load and run), then the measured run: the YCSB-E
    mix (95% zipfian SCANs / 5% inserts) arrives at ``rate`` while a
    background writer streams fresh keys at the same fixed ``write_rate``
    for every policy (db_bench's ``--benchmark_write_rate_limit``
    convention; the default sits inside every policy's sustainable region
    at the benchmark scale).  The scan tail then captures how each
    policy's compaction behaviour — chain width, write stalls, device
    busy time — bleeds into foreground range queries: the paper's
    read-tail mechanism (P99 reads up to 12.5x), extended to scans."""
    scale = scale or cfg.memtable_size
    lam = scale / (64 << 20)
    w_rate = write_rate
    pop = np.unique(load_keys(n_pop, seed))
    spec = make_run_e(pop, n_ops, dist="zipfian", seed=seed + 3)
    load_arrivals, run_arrivals = _load_settle_run(pop.shape[0], n_ops,
                                                   rate, settle_s)
    t_run = run_arrivals[0]
    n_wr = int(n_ops / rate * w_rate)
    writer_keys = load_keys(n_wr, seed + 9)
    writer_arrivals = t_run + np.arange(n_wr, dtype=np.float64) / w_rate
    op_types = np.concatenate([np.zeros(pop.shape[0], np.uint8),
                               spec.op_types,
                               np.zeros(n_wr, np.uint8)])
    keys = np.concatenate([pop, spec.keys, writer_keys])
    scan_lens = np.concatenate([np.zeros(pop.shape[0], np.int32),
                                spec.scan_lens,
                                np.zeros(n_wr, np.int32)])
    arrivals = np.concatenate([load_arrivals, run_arrivals, writer_arrivals])
    order = np.argsort(arrivals, kind="stable")
    sim = Simulator(cfg, DeviceModel.scaled(lam),
                    compute_device=compute_device)
    t0 = time.perf_counter()
    res = sim.run(op_types[order], keys[order], arrivals[order],
                  scan_lens=scan_lens[order])
    wall = time.perf_counter() - t0
    sc = res.op_types == OpKind.SCAN
    n_scans = max(1, int(sc.sum()))
    run_stalls = _run_phase_stalls(sim, pop.shape[0])
    return {
        "bench": "seekrandom", "workload": "run_e_while_writing",
        "policy": cfg.policy, "ops": n_ops,
        "write_rate_ops_s": int(w_rate),
        "p99_scan_ms": round(res.pct(99, op=int(OpKind.SCAN)) * 1e3, 3),
        "p999_scan_ms": round(res.pct(99.9, op=int(OpKind.SCAN)) * 1e3, 3),
        "p50_scan_ms": round(res.pct(50, op=int(OpKind.SCAN)) * 1e3, 3),
        "scan_blocks_per_op": round(sim.stats.scan_blocks / n_scans, 2),
        "scan_files_per_op": round(float(res.get_probed[sc].mean()), 2),
        "stall_total_s": round(sum(run_stalls), 4),
        "stall_max_ms": round(max(run_stalls, default=0.0) * 1e3, 2),
        "wall_clock_s": round(wall, 3),
        "index_backend": sim.compute_device.type,
    }


def ycsb_a(cfg: LSMConfig, n_ops: int = 60_000, n_pop: int = 60_000, *,
           scale: int | None = None, rate: float = 2_500.0,
           settle_s: float = 10.0, seed: int = 7,
           compute_device: str | torch.device = "cuda") -> dict:
    """YCSB-A mixed tails (50% zipfian GET / 50% update, §6.3 / Fig 12).

    Load-phase flood, a short compaction settle, then the measured run at
    a fixed arrival rate common to every policy — the open-loop,
    coordinated-omission-free methodology.  The default rate sits inside
    every policy's sustainable region at the benchmark scale, so tails
    compare compaction interference rather than queue divergence."""
    scale = scale or cfg.memtable_size
    lam = scale / (64 << 20)
    pop = np.unique(load_keys(n_pop, seed))
    spec = make_run_a(pop, n_ops, dist="zipfian")
    load_arrivals, run_arrivals = _load_settle_run(pop.shape[0], n_ops,
                                                   rate, settle_s)
    op_types = np.concatenate([np.zeros(pop.shape[0], np.uint8),
                               spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    arrivals = np.concatenate([load_arrivals, run_arrivals])
    sim = Simulator(cfg, DeviceModel.scaled(lam),
                    compute_device=compute_device)
    t0 = time.perf_counter()
    res = sim.run(op_types, keys, arrivals)
    wall = time.perf_counter() - t0
    n_load = pop.shape[0]
    run_lat = res.latency[n_load:]
    run_types = res.op_types[n_load:]
    get_lat = run_lat[run_types == OpKind.GET]
    put_lat = run_lat[run_types == OpKind.PUT]
    run_stalls = _run_phase_stalls(sim, n_load)
    return {
        "bench": "ycsb_a", "workload": "run_a", "dist": "zipfian",
        "policy": cfg.policy, "ops": n_ops, "rate_ops_s": int(rate),
        "p50_get_ms": round(float(np.percentile(get_lat, 50)) * 1e3, 3),
        "p99_get_ms": round(float(np.percentile(get_lat, 99)) * 1e3, 3),
        "p999_get_ms": round(float(np.percentile(get_lat, 99.9)) * 1e3, 3),
        "p99_put_ms": round(float(np.percentile(put_lat, 99)) * 1e3, 3),
        "p999_put_ms": round(float(np.percentile(put_lat, 99.9)) * 1e3, 3),
        "stall_total_s": round(sum(run_stalls), 4),
        "n_stalls": len(run_stalls),
        "io_amp": round(sim.stats.io_amp, 2),
        "wall_clock_s": round(wall, 3),
    }


def _sweep_row(cfg: LSMConfig, res, *, n_ops: int, n_load: int, rate: float,
               dist: str, wall: float, bench: str = "shard_sweep") -> dict:
    """Build one shard_sweep-schema row from a :class:`SimResult` alone
    (works for the serial engine and for fleet temporal passes: stall
    events and per-shard chain snapshots ride on the result)."""
    run_lat = res.latency[n_load:]
    run_types = res.op_types[n_load:]
    shard_ids = res.shard_ids if res.shard_ids is not None \
        else np.zeros(res.op_types.shape[0], np.int64)
    run_shards = shard_ids[n_load:]
    get_lat = run_lat[run_types == OpKind.GET]
    put_lat = run_lat[run_types == OpKind.PUT]
    run_stalls = [d for i, d in res.stall_events if i >= n_load]
    per_shard = []
    for s in range(cfg.n_shards):
        m = run_shards == s
        gl = run_lat[m & (run_types == OpKind.GET)]
        s_stalls = [d for i, d in res.stall_events
                    if i >= n_load and shard_ids[i] == s]
        per_shard.append({
            "shard": s,
            "ops": int(m.sum()),
            "p99_get_ms": round(float(np.percentile(gl, 99)) * 1e3, 3)
            if gl.size else 0.0,
            "stall_s": round(sum(s_stalls), 4),
            # write-stop time the DES pinned on this shard's chains
            # (whole run: chains are load-born but stall the run phase)
            "chain_stall_s": round(res.chain_stall_s[s], 4),
            "n_chains": res.chain_counts[s],
        })
    run_ops = np.array([p["ops"] for p in per_shard], np.float64)
    return {
        "bench": bench, "workload": "run_a", "dist": dist,
        "policy": cfg.policy, "n_shards": cfg.n_shards,
        "router": cfg.shard_router, "ops": n_ops, "rate_ops_s": int(rate),
        "p99_get_ms": round(float(np.percentile(get_lat, 99)) * 1e3, 3),
        "p999_get_ms": round(float(np.percentile(get_lat, 99.9)) * 1e3, 3),
        "p99_put_ms": round(float(np.percentile(put_lat, 99)) * 1e3, 3),
        "p999_put_ms": round(float(np.percentile(put_lat, 99.9)) * 1e3, 3),
        "stall_total_s": round(sum(run_stalls), 4),
        "n_stalls": len(run_stalls),
        "io_amp": round(res.stats.io_amp, 2),
        "hot_shard_frac": round(
            float(run_ops.max() / max(1.0, run_ops.sum())), 3),
        "per_shard": per_shard,
        "wall_clock_s": round(wall, 3),
    }


def shard_sweep(cfg: LSMConfig, n_ops: int = 30_000, n_pop: int = 40_000, *,
                dist: str = "uniform", scale: int | None = None,
                rate: float = 2_500.0, settle_s: float = 10.0,
                seed: int = 7,
                compute_device: str | torch.device = "cuda") -> dict:
    """Sharded-fleet tails: YCSB-A at a fixed AGGREGATE rate over
    ``cfg.n_shards`` hash shards contending for one shared device.

    The aggregate arrival rate (and the device) is the same at every
    shard count, so the row isolates what partitioning itself buys or
    costs.  ``dist="zipf_ranked"`` with ``cfg.shard_router="range"`` is the
    hot-shard scenario — rank-ordered zipfian popularity co-locates the
    hot ranks in one shard's stripe — and the ``per_shard`` breakdown
    shows the hot shard's chains soaking up the stall attribution
    (``chain_stall_s``) while the busy device inflates EVERY shard's read
    tail (``p99_get_ms`` of cold shards).
    """
    scale = scale or cfg.memtable_size
    lam = scale / (64 << 20)
    pop = np.unique(load_keys(n_pop, seed))
    spec = make_run_a(pop, n_ops, dist=dist)
    load_arrivals, run_arrivals = _load_settle_run(pop.shape[0], n_ops,
                                                   rate, settle_s)
    op_types = np.concatenate([np.zeros(pop.shape[0], np.uint8),
                               spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    arrivals = np.concatenate([load_arrivals, run_arrivals])
    sim = Simulator(cfg, DeviceModel.scaled(lam),
                    compute_device=compute_device)
    t0 = time.perf_counter()
    res = sim.run(op_types, keys, arrivals)
    wall = time.perf_counter() - t0
    return _sweep_row(cfg, res, n_ops=n_ops, n_load=pop.shape[0],
                      rate=rate, dist=dist, wall=wall)


def fleet_points(policies: list[str], n_ops: int = 30_000,
                 n_pop: int = 40_000, *, dist: str = "uniform",
                 scale: int | None = None,
                 rates: tuple[float, ...] | None = None,
                 shard_counts: tuple[int, ...] | None = None,
                 settle_s: float = 10.0, seed: int = 7
                 ) -> tuple[list[SweepPoint], int]:
    """The ``fleet_sweep`` matrix: one :class:`SweepPoint` per (policy,
    shard count), in that order, each carrying the whole rate axis as its
    ``arrivals_grid`` (one YCSB-A stream: the load flood, a settle, the
    run at each rate).  Returns the points and the load-phase op count."""
    if rates is None:
        rates = FLEET_RATES
    if shard_counts is None:
        shard_counts = FLEET_SHARD_COUNTS
    scale = scale or (1 << 18)
    lam = scale / (64 << 20)
    device = DeviceModel.scaled(lam)
    pop = np.unique(load_keys(n_pop, seed))
    spec = make_run_a(pop, n_ops, dist=dist)
    n_load = pop.shape[0]
    op_types = np.concatenate([np.zeros(n_load, np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    grid = []
    for rate in rates:
        load_arr, run_arr = _load_settle_run(n_load, n_ops, rate, settle_s)
        grid.append(np.concatenate([load_arr, run_arr]))
    points = [SweepPoint(label=f"{nm}/{k}",
                         cfg=get_policy(nm).default_config(scale=scale)
                         .with_(n_shards=k),
                         device=device, op_types=op_types, keys=keys,
                         arrivals_grid=grid)
              for nm in policies for k in shard_counts]
    return points, n_load


def fleet_sweep_bench(policies: list[str], n_ops: int = 30_000,
                      n_pop: int = 40_000, *, dist: str = "uniform",
                      scale: int | None = None,
                      rates: tuple[float, ...] | None = None,
                      shard_counts: tuple[int, ...] | None = None,
                      settle_s: float = 10.0, seed: int = 7,
                      compute_device: str | torch.device = "cuda",
                      serial_baseline: bool = True,
                      workers: int = 1, cache=None) -> list[dict]:
    """Policy × shard-count × arrival-rate matrix through the sweep
    executor (``repro_torch.core.sweeps``) over the two-phase fleet
    engine, with the serial heap-loop as timed baseline and parity oracle.

    Every (policy, shard count) point shares ONE structural replay (or
    skips it on a structural-cache hit); each rate on the load curve is a
    temporal pass over it plus one lindley_scan launch.  ``workers > 1``
    dispatches points over the executor's spawn pool — rows are identical
    at every worker count (namespace-isolated uid streams).  The serial
    baseline replays the full heap loop per (point, rate), over the same
    pool.

    Emits one ``shard_sweep``-schema row per (point, rate) with
    ``bench="fleet_sweep"``/``engine="fleet"`` (``wall_clock_s`` is the
    fleet matrix wall amortized per run) carrying the executor's
    per-phase timing (``structural_s`` on the point's first rate row,
    ``temporal_s``/``lindley_s``/``finalize_s`` per rate, ``cache_hit``),
    then a summary row with the matrix walls, the measured speedup and
    the worst per-op latency parity gap against the serial oracle.
    """
    if rates is None:
        rates = FLEET_RATES
    if shard_counts is None:
        shard_counts = FLEET_SHARD_COUNTS
    points, n_load = fleet_points(policies, n_ops, n_pop, dist=dist,
                                  scale=scale, rates=rates,
                                  shard_counts=shard_counts,
                                  settle_s=settle_s, seed=seed)
    n_runs = len(points) * len(rates)

    t0 = time.perf_counter()
    fleet_res, ftimings = sweep_execute(points, workers=workers,
                                        compute_device=compute_device,
                                        cache=cache)
    t_fleet = time.perf_counter() - t0

    rows = []
    for p, per_rate, ft in zip(points, fleet_res, ftimings):
        for ri, (rate, res) in enumerate(zip(rates, per_rate)):
            row = _sweep_row(p.cfg, res, n_ops=n_ops, n_load=n_load,
                             rate=rate, dist=dist, wall=t_fleet / n_runs,
                             bench="fleet_sweep")
            row["engine"] = "fleet"
            frag = ft.row(ri)
            row["structural_s"] = frag["structural_s"]
            row["temporal_s"] = frag["temporal_s"]
            row["lindley_s"] = frag["lindley_s"]
            row["finalize_s"] = frag["finalize_s"]
            row["cache_hit"] = frag["cache_hit"]
            rows.append(row)

    summary = {
        "bench": "fleet_sweep", "engine": "summary", "dist": dist,
        "policies": list(policies), "shard_counts": list(shard_counts),
        "n_rates": len(rates), "runs": n_runs, "ops": n_ops,
        "backend": torch.device(compute_device).type, "workers": workers,
        "fleet_wall_s": round(t_fleet, 3),
        "wall_clock_s": round(t_fleet, 3),
    }
    if serial_baseline:
        t0 = time.perf_counter()
        serial_res = serial_sweep_parallel(points, workers=workers,
                                           compute_device=compute_device)
        t_serial = time.perf_counter() - t0
        dlat, stalls_eq = 0.0, True
        for pf, ps in zip(fleet_res, serial_res):
            for a, b in zip(pf, ps, strict=True):
                dlat = max(dlat, float(np.max(np.abs(a.latency - b.latency))))
                stalls_eq &= (a.n_stalls == b.n_stalls)
        summary.update({
            "serial_wall_s": round(t_serial, 3),
            "speedup": round(t_serial / max(t_fleet, 1e-9), 2),
            "parity_max_abs_latency_s": float(dlat),
            "parity_stalls_equal": bool(stalls_eq),
            "wall_clock_s": round(t_fleet + t_serial, 3),
        })
    rows.append(summary)
    return rows


def make_serve_spec(*, duration_s: float = 4.0, population: int = 8_000,
                    seed: int = 7, admission: bool = False):
    """The pinned multi-tenant serve_sweep scenario (see docs/benchmarks.md).

    Three tenants over ``SERVE_SHARDS`` hash shards: a high-priority
    read-heavy tenant with a tight SLO (priority 0 — never shed), a
    bursty mixed tenant (priority 1), and a bulk write stream
    (priority 2 — shed first).  At ``load_factor`` 1.0 the aggregate
    offered rate is ``SERVE_BASE_RATE``; the factor axis scales every
    tenant's rate by compressing simulated time, sweeping across the
    saturation knee.
    """
    from ..serving import AdmissionConfig, TenantSpec, TrafficSpec
    base = SERVE_BASE_RATE
    return TrafficSpec(
        tenants=(
            TenantSpec("prio", rate_ops_s=0.15 * base, mix="ycsb_b",
                       arrival="poisson", priority=0, slo_ms=25.0),
            TenantSpec("mid", rate_ops_s=0.35 * base, mix="ycsb_a",
                       arrival="bursty", priority=1, slo_ms=60.0),
            TenantSpec("bulk", rate_ops_s=0.5 * base, mix="load",
                       arrival="poisson", priority=2, slo_ms=250.0),
        ),
        duration_s=duration_s, population=population, seed=seed,
        admission=AdmissionConfig() if admission else None)


#: timing fragment for serve results that never went through the
#: executor (direct ``serve`` calls outside the grid path)
_NO_TIMING = {"structural_s": 0.0, "temporal_s": 0.0, "lindley_s": 0.0,
              "finalize_s": 0.0, "cache_hit": False}


def serve_row(cfg: LSMConfig, sr, *, factor: float, admission_on: bool,
              wall: float) -> dict:
    """One serve_sweep-schema row from a ``ServeResult``.

    Phase timing rides in ``sr.timing`` (set by ``serve_grid``):
    admission-off factors report the executor's per-phase split
    (``structural_s`` on the grid's first factor, or 0.0 on a
    structural-cache hit), admission-on factors run a serial engine
    with no phase split, so the whole run lands in ``structural_s``."""
    stream = sr.stream
    timing = sr.timing if sr.timing is not None else _NO_TIMING
    measured = (stream.tenant_ids >= 0) & ~np.isnan(sr.latency_full)
    get_lat = sr.latency_full[measured & (stream.op_types == OpKind.GET)]
    run_stalls = [d for i, d in sr.res.stall_events if i >= stream.n_load]
    per_tenant = []
    for ti, led in enumerate(sr.tenants):
        lat = sr.tenant_latency(ti)
        per_tenant.append({
            "tenant": led.name, "priority": led.priority,
            "slo_ms": led.slo_ms, "ops_offered": led.ops_offered,
            "shed_frac": round(led.shed_frac, 4),
            "throttled_frac": round(led.throttled_frac, 4),
            "slo_violation_frac": round(led.slo_violation_frac, 4),
            "goodput_ops_s": round(led.goodput_ops_s(sr.duration_s), 1),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)
            if lat.size else 0.0,
            "p999_ms": round(float(np.percentile(lat, 99.9)) * 1e3, 3)
            if lat.size else 0.0,
        })
    return {
        "bench": "serve_sweep", "workload": "multi_tenant",
        "policy": cfg.policy, "n_shards": cfg.n_shards,
        "admission": "on" if admission_on else "off",
        "ops": int(sr.offered_ops), "load_factor": round(factor, 3),
        "offered_ops_s": round(sr.offered_ops_s, 1),
        "goodput_ops_s": round(sr.goodput_ops_s, 1),
        "shed_frac": round(sr.shed_frac, 4),
        "throttled_frac": round(sr.throttled_frac, 4),
        "slo_violation_frac": round(sr.slo_violation_frac, 4),
        "p99_get_ms": round(float(np.percentile(get_lat, 99)) * 1e3, 3)
        if get_lat.size else 0.0,
        "p999_get_ms": round(float(np.percentile(get_lat, 99.9)) * 1e3, 3)
        if get_lat.size else 0.0,
        "stall_total_s": round(sum(run_stalls), 4),
        "structural_s": timing["structural_s"],
        "temporal_s": timing["temporal_s"],
        "lindley_s": timing["lindley_s"],
        "finalize_s": timing["finalize_s"],
        "cache_hit": timing["cache_hit"],
        "per_tenant": per_tenant,
        "wall_clock_s": round(wall, 3),
    }


def serve_sweep_bench(policies: list[str], *, duration_s: float = 4.0,
                      population: int = 8_000,
                      factors: tuple[float, ...] = None,
                      scale: int | None = None, seed: int = 7,
                      compute_device: str | torch.device = "cuda",
                      workers: int = 1, cache=None) -> list[dict]:
    """Goodput-vs-offered-load curves per policy, admission off and on.

    The offered-load axis is swept with ``repro_torch.serving.serve_grid``
    through the sweep executor: admission-off curves amortize ONE fleet
    structural replay per policy (the stream is factor-invariant, only
    arrivals compress) — or skip it entirely on a structural-cache hit —
    and admission-on points run a fresh serial engine each (the admitted
    subset differs per factor), dispatched over the executor's spawn pool
    when ``workers > 1``.  Rows are identical at every worker count.  Off curves show the open-loop collapse past the knee —
    vlsm's narrow chains push the knee right — and on curves show the
    controller buying bounded high-priority tails with ``shed_frac`` > 0.
    """
    from ..serving import serve_grid
    if factors is None:
        factors = SERVE_FACTORS
    scale = scale or (1 << 18)
    lam = scale / (64 << 20)
    device = DeviceModel.scaled(lam)
    rows = []
    for nm in policies:
        for adm in (False, True):
            spec = make_serve_spec(duration_s=duration_s,
                                   population=population, seed=seed,
                                   admission=adm)
            cfg = get_policy(nm).default_config(scale=scale) \
                .with_(n_shards=SERVE_SHARDS)
            t0 = time.perf_counter()
            results = serve_grid(cfg, device, spec, factors,
                                 compute_device=compute_device,
                                 workers=workers, cache=cache)
            wall = (time.perf_counter() - t0) / len(factors)
            for f, sr in zip(factors, results):
                rows.append(serve_row(cfg, sr, factor=f, admission_on=adm,
                                      wall=wall))
    return rows


BENCHES = ("fillrandom", "read_path", "ycsb_a", "seekrandom",
           "chain_report", "shard_sweep", "fleet_sweep", "serve_sweep")
SHARD_COUNTS = (1, 2, 4)      # the sweep axis (fixed aggregate rate)
SWEEP_RATE = 5_000.0          # aggregate ops/s: stresses x1, easy at x4
# fleet_sweep: the batched-engine matrix — the rate axis is the paper's
# fixed-rate load curve, swept in one structural replay per point
FLEET_SHARD_COUNTS = (1, 2, 4, 16)
FLEET_RATES = tuple(
    float(r) for r in np.geomspace(1_250.0, 20_000.0, 32))
FLEET_RATES_QUICK = tuple(
    float(r) for r in np.geomspace(2_000.0, 8_000.0, 4))
# serve_sweep: the open-loop multi-tenant traffic layer — offered load
# swept by compressing simulated time (the stream is factor-invariant,
# so admission-off curves share one fleet structural replay per policy)
SERVE_BASE_RATE = 4_000.0     # aggregate offered ops/s at load_factor 1.0
SERVE_SHARDS = 2              # shards of the pinned serve scenario
SERVE_FACTORS = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)
SERVE_FACTORS_QUICK = (0.5, 1.5, 3.0)
HOT_SHARDS = 4                # shard count of the Zipf hot-shard scenario
HOT_RATE = 14_000.0           # hot scenario rate: the hot shard saturates
                              # and write-stops while its chains keep the
                              # shared device busy, inflating every
                              # shard's read tail


def main(argv=None) -> list[dict]:
    """Run the chosen benches and return their rows (also written to
    ``--json`` when it names a file)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="",
                    help="write JSON rows here (default '': no file)")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (~10x fewer ops)")
    ap.add_argument("--policy", default="all",
                    help="registry policy name(s), comma-separated, or "
                         f"'all' (registered: {', '.join(policy_names())})")
    ap.add_argument("--bench", default="all",
                    help="bench name(s), comma-separated, or 'all' "
                         f"(available: {', '.join(BENCHES)})")
    ap.add_argument("--seed", type=int, default=7,
                    help="base RNG seed for every workload (default 7)")
    ap.add_argument("--workers", type=int, default=1,
                    help="sweep-executor spawn-pool size for fleet_sweep/"
                         "serve_sweep (1 = in-process; rows are identical "
                         "at every worker count)")
    ap.add_argument("--compute-device", default="cuda",
                    help="torch device of the store (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    seed = args.seed
    if args.bench == "all":
        benches = set(BENCHES)
    else:
        benches = {b.strip() for b in args.bench.split(",")}
        unknown = benches - set(BENCHES)
        if unknown:
            ap.error(f"unknown bench(es) {sorted(unknown)}; "
                     f"available: {', '.join(BENCHES)}")
    dev = resolve_compute_device(args.compute_device)
    scale = 1 << 18
    n_fill = 12_000 if args.quick else 120_000
    n_read = 20_000 if args.quick else 200_000
    n_pop = 10_000 if args.quick else 100_000
    n_scan = 4_000 if args.quick else 40_000
    n_scan_pop = 10_000 if args.quick else 60_000
    n_mixed = 8_000 if args.quick else 60_000
    n_mixed_pop = 10_000 if args.quick else 60_000
    n_shard = 6_000 if args.quick else 30_000
    n_shard_pop = 8_000 if args.quick else 40_000

    # Resolve the policy sweep from the registry: a policy registered
    # tomorrow shows up in every bench below with zero edits here.
    try:
        chosen = resolve_names(args.policy)
    except KeyError:
        ap.error(f"unknown policy name(s) in {args.policy!r}; "
                 f"registered: {', '.join(policy_names())}")

    def cfg_for(name: str) -> LSMConfig:
        return get_policy(name).default_config(scale=scale)

    # per-run executor accounting (feeds the perf_trajectory row below)
    LEDGER.reset()
    rows = []
    # The uniform fillrandom runs are shared with chain_report (same cfg /
    # ops / dist / seed): one simulation feeds both rows.
    fill_runs: dict[str, tuple] = {}
    if "fillrandom" in benches:
        for dist in ("uniform", "pareto"):
            for name in chosen:
                cfg = cfg_for(name)
                run = fill_sim(cfg, n_fill, dist, scale, seed, dev)
                if dist == "uniform":
                    fill_runs[name] = (cfg, run)
                row = fillrandom(cfg, n_fill, dist=dist, scale=scale,
                                 seed=seed, run=run)
                rows.append(row)
                print(f"db_bench.{dist}.{name}: {row}")
    if "read_path" in benches:
        for name in chosen:
            row = read_path(cfg_for(name), n_read, n_pop, scale=scale,
                            seed=seed, compute_device=dev)
            rows.append(row)
            print(f"db_bench.read_path.{name}: {row}")
    # ycsb_a: mixed read/update tails for every policy at the same memory
    # budget (same `scale`) and the same request rate.
    if "ycsb_a" in benches:
        for name in chosen:
            row = ycsb_a(cfg_for(name), n_mixed, n_mixed_pop, scale=scale,
                         seed=seed, compute_device=dev)
            rows.append(row)
            print(f"db_bench.ycsb_a.{name}: {row}")
    # seekrandom / YCSB-E: scan tails for every policy.
    if "seekrandom" in benches:
        for name in chosen:
            row = seekrandom(cfg_for(name), n_scan, n_scan_pop, scale=scale,
                             seed=seed, compute_device=dev)
            rows.append(row)
            print(f"db_bench.seekrandom.{name}: {row}")
    # chain_report: width/length/critical-path distributions per policy
    # on the same fillrandom stream.
    if "chain_report" in benches:
        for name in chosen:
            cfg, run = fill_runs.get(name) or (cfg_for(name), None)
            row = chain_report(cfg, n_fill, scale=scale, seed=seed, run=run,
                               compute_device=dev)
            rows.append(row)
            print(f"db_bench.chain_report.{name}: {row}")
    # shard_sweep: fleet P99/P99.9 vs shard count at a fixed aggregate
    # rate, then the Zipf hot-shard interference scenario at HOT_SHARDS.
    if "shard_sweep" in benches:
        for name in chosen:
            for k in SHARD_COUNTS:
                cfg = cfg_for(name).with_(n_shards=k)
                row = shard_sweep(cfg, n_shard, n_shard_pop, scale=scale,
                                  rate=SWEEP_RATE, seed=seed,
                                  compute_device=dev)
                rows.append(row)
                print(f"db_bench.shard_sweep.{name}.x{k}: {row}")
            # Zipf hot-shard: rank-ordered zipfian over the RANGE router
            # co-locates the hot ranks in one shard's stripe.
            cfg = cfg_for(name).with_(n_shards=HOT_SHARDS,
                                      shard_router="range")
            row = shard_sweep(cfg, n_shard, n_shard_pop, dist="zipf_ranked",
                              scale=scale, rate=HOT_RATE, seed=seed,
                              compute_device=dev)
            rows.append(row)
            print(f"db_bench.shard_hot.{name}.x{HOT_SHARDS}: {row}")
    # fleet_sweep: the two-phase engine over the full policy x shard-count
    # x rate matrix — one structural replay per point, one temporal pass
    # and one lindley_scan launch per rate — timed against the serial
    # heap-loop oracle on the same matrix.
    if "fleet_sweep" in benches:
        frates = FLEET_RATES_QUICK if args.quick else FLEET_RATES
        fshards = (1, 4, 16) if args.quick else FLEET_SHARD_COUNTS
        frows = fleet_sweep_bench(chosen, n_shard, n_shard_pop,
                                  scale=scale, rates=frates,
                                  shard_counts=fshards, seed=seed,
                                  compute_device=dev,
                                  workers=args.workers,
                                  cache=DEFAULT_CACHE)
        rows.extend(frows)
        print(f"db_bench.fleet_sweep: {frows[-1]}")
    # serve_sweep: goodput vs offered load for the pinned multi-tenant
    # scenario, admission off (open-loop collapse past the knee) and on
    # (priority-aware shedding keeps high-priority tails bounded).
    if "serve_sweep" in benches:
        sfactors = SERVE_FACTORS_QUICK if args.quick else SERVE_FACTORS
        sdur = 1.5 if args.quick else 4.0
        spop = 3_000 if args.quick else 8_000
        srows = serve_sweep_bench(chosen, duration_s=sdur, population=spop,
                                  factors=sfactors, scale=scale, seed=seed,
                                  compute_device=dev, workers=args.workers,
                                  cache=DEFAULT_CACHE)
        rows.extend(srows)
        for r in srows:
            if r["load_factor"] == sfactors[-1]:
                print(f"db_bench.serve_sweep.{r['policy']}."
                      f"adm_{r['admission']}.x{r['load_factor']}: "
                      f"goodput={r['goodput_ops_s']} "
                      f"shed={r['shed_frac']} "
                      f"p999_get_ms={r['p999_get_ms']}")
    # perf_trajectory: this run's executor activity — wall-clock vs the
    # summed per-task compute (the serial single-process cost of the same
    # tasks).
    if LEDGER.tasks:
        row = {
            "bench": "perf_trajectory", "workers": args.workers,
            "tasks": LEDGER.tasks,
            "cache_hits": LEDGER.cache_hits,
            "cache_misses": LEDGER.cache_misses,
            "executor_wall_s": round(LEDGER.wall_s, 3),
            "serial_equiv_s": round(LEDGER.task_s, 3),
            "speedup": round(LEDGER.speedup, 2),
            "wall_clock_s": round(LEDGER.wall_s, 3),
        }
        rows.append(row)
        print(f"db_bench.perf_trajectory: {row}")
    # under REPRO_PARANOID_CHECKS=1 every row must match the schema the
    # port's lint extracts from this module's dict literals (B6xx):
    # emitter drift fails the run, not just the linter
    from ..analysis.schemas import paranoid_validate_rows
    paranoid_validate_rows(rows)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
        print(f"wrote {args.json} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
