#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which must pass (any failure raises and exits non-zero):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   three kernels from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel) into ``build/repro_torch/``.
2. Kernel edge cases: every kernel against its plain PyTorch version on the
   card (merge and rank exactly, Lindley within 1e-9 s).
3. Main path: ``Simulator.run`` on the card for vlsm and rocksdb at the
   paper's byte scale (64 MiB scale, ``DeviceModel.scaled(1.0)``, 200-byte
   pairs): 8,000,000 uniform keys loaded at 500,000 ops/s, a 10 s settle,
   then 2,000,000 YCSB Run A ops (50% GET / 50% update, Zipfian 0.99) at
   8,000 ops/s.  Launch counts are zeroed just before and read just after;
   every kernel must have launched.
4. Kernel timings at the main path's shapes (real tree data from the vlsm
   run): kernel, plain version and library call — ``ms``, the median of
   five CUDA-event-timed trials of back-to-back calls, and ``device_ms``,
   the kernels' own device time from torch.profiler — beside the memory
   bound at 3.35 TB/s (for the rank: the keys, the ranks and the distinct
   fence entries its searches read).
5. Cross-check: the same main path, at full size, with
   ``compute_device="cpu"`` (the plain PyTorch tier) against the card runs
   of phase 3: per-op reads/probed and stall counts identical, latency
   within 1e-9 s.
6. Where the time goes: the vlsm main path once under torch.profiler
   (device busy time by kernel) and once under cProfile (host hot spots).

Prints the card line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  ``--out DIR`` also writes every number
to ``DIR/chip_smoke.json``.  Exits non-zero without a result when torch
sees no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
LINDLEY_TOL_S = 1e-9
N_LOAD = 8_000_000             # uniform keys loaded (before de-duplication)
N_RUN = 2_000_000              # YCSB Run A ops after the settle


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Per-call time: ``reps`` back-to-back calls between two CUDA events,
    median of five trials after two warm-up calls.  Where a call's host
    work outlasts its kernels, this is the host's launch rate."""
    fn()
    fn()
    trials = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        trials.append(start.elapsed_time(end) / reps)
    trials.sort()
    return trials[2]


def kernel_times_us(prof) -> list[tuple[str, float, int]]:
    """(name, total device microseconds, count) of every device-side event
    (kernels and copies) a torch.profiler run recorded."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, reps: int) -> float | None:
    """Device time per call: the durations of the kernels ``reps`` calls
    launch, from torch.profiler (None when it records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(us for _, us, _ in kernel_times_us(prof))
    return total / reps / 1e3 if total > 0 else None


def time_all(torch, kernel, plain, library, reps: int) -> dict:
    """``*ms``: CUDA-event time per call of back-to-back calls, median of
    five trials, host launch work included; ``*device_ms``: the kernels' own
    device time per call from torch.profiler (None if it records none)."""
    out = {"library_ms": None, "library_device_ms": None}
    for key, fn, n in (("", kernel, reps), ("plain_", plain, max(1, reps // 4)),
                       ("library_", library, reps)):
        if fn is None:
            continue
        out[f"{key}ms"] = cuda_ms(torch, fn, n)
        out[f"{key}device_ms"] = device_ms(torch, fn, n)
    return out


def distinct_probes(torch, fences, keys, side: str) -> int:
    """Fence entries a binary search of every key reads, counted once: the
    bytes a rank of this run's keys must move, beside the keys and ranks."""
    n = int(fences.shape[0])
    lo = torch.zeros_like(keys)
    hi = torch.full_like(keys, n)
    seen = []
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        seen.append(mid[active])
        v = fences[mid.clamp(max=n - 1)]
        below = (v <= keys) if side == "right" else (v < keys)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return int(torch.unique(torch.cat(seen)).numel())


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------- workloads
def ycsb_trace(np, n_load: int, n_run: int, seed: int = 7):
    """Load (unique uniform keys, 500k ops/s), 10 s settle, Run A at 8k/s."""
    from repro_torch.bench_kv.workloads import load_keys, make_run_a
    pop = np.unique(load_keys(n_load, seed=seed))
    spec = make_run_a(pop, n_run, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    load = np.arange(pop.shape[0], dtype=np.float64) / 500_000.0
    run = load[-1] + 10.0 + np.arange(n_run, dtype=np.float64) / 8_000.0
    return ops, keys, np.concatenate([load, run]), pop.shape[0]


def run_main_path(torch, np, policy: str, trace, compute_device: str):
    from repro_torch.core import (DeviceModel, Simulator, UidNamespace,
                                  get_policy)
    cfg = get_policy(policy).default_config(scale=64 << 20)
    sim = Simulator(cfg, DeviceModel.scaled(1.0), uids=UidNamespace(),
                    compute_device=compute_device)
    ops, keys, arrivals, _ = trace
    t0 = time.perf_counter()
    res = sim.run(ops, keys, arrivals)
    if compute_device == "cuda":
        torch.cuda.synchronize()
    return sim, res, time.perf_counter() - t0


def summarize(np, sim, res, n_load: int, wall: float) -> dict:
    lat = res.latency[n_load:]
    kinds = res.op_types[n_load:]
    if lat.size == 0 or not np.all(np.isfinite(res.latency)) \
            or np.any(res.latency < 0):
        fail("latencies must be finite and non-negative")
    put, get = lat[kinds == 0], lat[kinds == 1]
    st = sim.stats
    run_stalls = [d for i, d in sim.stall_events if i >= n_load]
    return {
        "wall_s": wall,
        "levels_mb": [s / 1e6 for s in sim.trees[0].level_sizes()],
        "p99_put_ms": float(np.percentile(put, 99)) * 1e3,
        "p999_put_ms": float(np.percentile(put, 99.9)) * 1e3,
        "p99_get_ms": float(np.percentile(get, 99)) * 1e3,
        "p999_get_ms": float(np.percentile(get, 99.9)) * 1e3,
        "n_stalls": res.n_stalls, "stall_total_s": res.stall_total,
        "run_phase_stalls": len(run_stalls),
        "run_phase_stall_s": float(sum(run_stalls)),
        "n_chains": len(st.l0_chains),
        "mean_chain_width_ssts": st.mean_chain_fanin,
        "effective_chain_length": st.effective_chain_length,
        "io_amp": st.io_amp,
    }


# ------------------------------------------------------------ edge checks
def check_equal(torch, what: str, got, want) -> int:
    """Fails unless every pair is equal; returns the largest |got - want|."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"{what}: kernel's shape differs from its plain version's")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
        if err or not torch.equal(g, w):
            fail(f"{what}: kernel disagrees with its plain version")
    return err


def edge_merge(torch, np, rng) -> int:
    from repro_torch.kernels.merge_path.ops import (merge_two_runs,
                                                    merge_two_runs_plain)
    big = 2 ** 62
    cases = [
        (np.array([-big, 0, 5, big]), np.array([-big, 5, 6, big])),
        (np.array([], np.int64), np.array([1, 2, 3])),
        (np.array([1, 2, 3]), np.array([], np.int64)),
        (np.array([-2 ** 63, 7]), np.array([-2 ** 63, 2 ** 63 - 1])),
        (np.unique(rng.integers(-1000, 1000, 1500)),
         np.unique(rng.integers(-1000, 1000, 900))),
    ]
    err = 0
    for a, b in cases:
        a = torch.tensor(np.asarray(a, np.int64), device="cuda")
        b = torch.tensor(np.asarray(b, np.int64), device="cuda")
        sa = torch.arange(a.shape[0], device="cuda") + 2 ** 40
        sb = torch.arange(b.shape[0], device="cuda") + 2 ** 41
        err = max(err, check_equal(torch, "merge_path edge case",
                                   merge_two_runs(a, sa, b, sb),
                                   merge_two_runs_plain(a, sa, b, sb)))
    return err


def edge_rank(torch, np, rng) -> int:
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    lo, hi = -2 ** 63, 2 ** 63 - 1
    fence_sets = [np.array([], np.int64), np.array([3, 3, 3, 9, 9]),
                  np.array([lo, 0, hi]),
                  np.sort(rng.integers(-50, 50, 7000)),        # global path
                  np.sort(rng.integers(-50, 50, 6144))]        # shared path
    keys = np.concatenate([[lo, hi, lo + 1, hi - 1, 0, 3, 9],
                           rng.integers(-60, 60, 3000)]).astype(np.int64)
    k = torch.tensor(keys, device="cuda")
    err = 0
    for fences in fence_sets:
        f = torch.tensor(np.asarray(fences, np.int64), device="cuda")
        for side in ("right", "left"):
            got = fence_rank(f, k, side)
            want = torch.from_numpy(np.searchsorted(fences, keys, side)
                                    .astype(np.int64)).to("cuda")
            err = max(err, check_equal(
                torch, f"overlap_scan edge case ({side})", [got, got],
                [fence_rank_plain(f, k, side), want]))
    return err


def edge_lindley(torch, np, rng) -> float:
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    lens = [0, 1, 1023, 1024, 1025, 0, 5000, 1_500_000]
    d0 = [0.0, 3.0, -np.inf, 1.0, -np.inf, 2.0, 0.5, -np.inf]
    n = sum(lens)
    service = rng.exponential(2e-6, n)
    arrivals = np.concatenate([np.sort(rng.uniform(0, 300, m)) for m in lens])
    offsets = np.concatenate([[0], np.cumsum(lens)])
    s = torch.from_numpy(service).to("cuda")
    a = torch.from_numpy(arrivals).to("cuda")
    got = lindley_batch(s, a, offsets, d0)
    want = lindley_batch_plain(s, a, offsets, d0)
    err = float((got - want).abs().max())
    if not err <= LINDLEY_TOL_S:
        fail(f"lindley_scan edge cases: max |err| {err} > {LINDLEY_TOL_S}")
    return err


# ---------------------------------------------------- main-shape timings
def time_merge(torch, sim) -> dict:
    from repro_torch.kernels.merge_path.ops import (merge_two_runs,
                                                    merge_two_runs_plain)
    tree = sim.trees[0]
    if tree.levels[0]:
        a_k, a_s = tree.levels[0][0].keys, tree.levels[0][0].seqs
    else:
        a_k, a_s = tree.memtable.to_sorted()
    b_k, b_s = tree._flat_level(1)
    got = merge_two_runs(b_k, b_s, a_k, a_s)
    err = check_equal(torch, "merge_path at the main path's shape", got,
                      merge_two_runs_plain(b_k, b_s, a_k, a_s))
    n = int(a_k.shape[0] + b_k.shape[0])
    return {
        "shape": f"L1 run {int(b_k.shape[0])} + L0 run {int(a_k.shape[0])}",
        "max_abs_err": err, "bound_ms": bound_ms(32 * n),
        **time_all(torch, lambda: merge_two_runs(b_k, b_s, a_k, a_s),
                   lambda: merge_two_runs_plain(b_k, b_s, a_k, a_s),
                   lambda: torch.sort(torch.cat([b_k, a_k]), stable=True),
                   40)}


def time_rank(torch, np, sim, trace) -> dict:
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    tree = sim.trees[0]
    deep = max(lv for lv in range(1, len(tree.levels)) if tree.levels[lv])
    fences, _ = tree._flat_level(deep)
    ops, keys, _, n_load = trace
    gets = keys[n_load:][ops[n_load:] == 1][:sim.cfg.keys_per_memtable]
    k = torch.from_numpy(np.ascontiguousarray(gets)).to("cuda")
    got = fence_rank(fences, k, "left")
    want = fence_rank_plain(fences, k, "left")
    lib = torch.searchsorted(fences, k, side="left")
    err = check_equal(torch, "overlap_scan at the main path's shape",
                      [got, got], [want, lib])
    m, n = int(k.shape[0]), int(fences.shape[0])
    return {
        "shape": f"{m} GET keys over flat L{deep} of {n} keys",
        "max_abs_err": err,
        "bound_ms": bound_ms(16 * m + 8 * distinct_probes(torch, fences, k,
                                                          "left")),
        "all_fences_bound_ms": bound_ms(8 * m + 8 * n + 8 * m),
        **time_all(torch, lambda: fence_rank(fences, k, "left"),
                   lambda: fence_rank_plain(fences, k, "left"),
                   lambda: torch.searchsorted(fences, k, side="left"), 40)}


def time_lindley(torch, np, sim, res) -> dict:
    """One queue of the main path's length: its real arrivals and its base
    service (per-kind CPU cost plus block reads at the device's block
    time), before busy inflation and stalls."""
    from repro_torch.core.sim import GET_CPU, PUT_SERVICE
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    dev = sim.device
    block_t = dev.io_latency + dev.block_size / dev.read_bw
    service = np.where(res.op_types == 1, GET_CPU, PUT_SERVICE) \
        + res.get_reads * block_t
    n = int(service.shape[0])
    s = torch.from_numpy(service).to("cuda")
    a = torch.from_numpy(res.arrivals.astype(np.float64)).to("cuda")
    offsets = [0, n]
    got = lindley_batch(s, a, offsets)
    err = float((got - lindley_batch_plain(s, a, offsets)).abs().max())
    if not err <= LINDLEY_TOL_S:
        fail(f"lindley_scan at the main path's shape: max |err| {err}")
    return {
        "shape": f"1 queue of {n} ops",
        "max_abs_err": err, "bound_ms": bound_ms(24 * n),
        **time_all(torch, lambda: lindley_batch(s, a, offsets),
                   lambda: lindley_batch_plain(s, a, offsets), None, 20)}


# ----------------------------------------------------- where time goes
def profile_main_path(torch, np, trace) -> dict:
    """The vlsm main path twice more: under torch.profiler for the device's
    busy time by kernel, and under cProfile for the host's hot spots."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_main_path(torch, np, "vlsm", trace, "cuda")
    rows = kernel_times_us(prof)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    host = cProfile.Profile()
    host.enable()
    _, _, host_wall = run_main_path(torch, np, "vlsm", trace, "cuda")
    host.disable()
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
    return {
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall,
        "top_device": [{"name": n[:90], "ms": us / 1e3, "count": c}
                       for n, us, c in rows[:12]],
        "cprofile_wall_s": host_wall,
        "top_host": [{"fn": f"{Path(f).name}:{line}:{fn}", "tottime_s": tt,
                      "calls": nc}
                     for (f, line, fn), (_cc, nc, tt, _ct, _cl) in top],
    }


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the detailed JSON report")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import _build

    report: dict = {}
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: [ln for ln in v.splitlines() if "ptxas" in ln]
                       for k, v in _build.ptxas_reports.items()}
    print(f"kernels built in {report['build_s']:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    edge_err = {"merge_path": edge_merge(torch, np, rng),
                "overlap_scan": edge_rank(torch, np, rng),
                "lindley_scan": edge_lindley(torch, np, rng)}
    torch.cuda.synchronize()
    print("kernel edge cases: merge_path and overlap_scan exact, "
          f"lindley_scan max |err| {edge_err['lindley_scan']:.3e} s", flush=True)

    trace = ycsb_trace(np, N_LOAD, N_RUN)
    kernels.reset_launch_counts()
    runs, launches, card_runs = {}, {}, {}
    before = kernels.launch_counts()
    for policy in ("vlsm", "rocksdb"):
        torch.cuda.reset_peak_memory_stats()
        sim, res, wall = run_main_path(torch, np, policy, trace, "cuda")
        after = kernels.launch_counts()
        launches[policy] = {k: after[k] - before[k] for k in after}
        before = after
        row = summarize(np, sim, res, trace[3], wall)
        row["launches"] = launches[policy]
        row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        runs[policy] = (sim, res)
        card_runs[policy] = (res.get_reads, res.get_probed, res.latency,
                             res.n_stalls)
        report[f"main_{policy}"] = row
        print(f"main path {policy}: " + json.dumps(row), flush=True)
        if min(launches[policy].values()) <= 0:
            fail(f"{policy}: a kernel never launched on the main path")
    total = kernels.launch_counts()

    sim, res = runs["vlsm"]
    timings = {"merge_path": time_merge(torch, sim),
               "overlap_scan": time_rank(torch, np, sim, trace),
               "lindley_scan": time_lindley(torch, np, sim, res)}
    for name, err in edge_err.items():
        timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"], err)
    del runs, sim, res
    for name, t in timings.items():
        print(f"timing {name}: " + json.dumps(t), flush=True)

    for policy in ("vlsm", "rocksdb"):
        reads, probed, latency, n_stalls = card_runs.pop(policy)
        _, r_cpu, w_cpu = run_main_path(torch, np, policy, trace, "cpu")
        if not (np.array_equal(reads, r_cpu.get_reads)
                and np.array_equal(probed, r_cpu.get_probed)):
            fail(f"cross-check {policy}: per-op reads/probed differ")
        err = float(np.max(np.abs(latency - r_cpu.latency)))
        if not err < LINDLEY_TOL_S or n_stalls != r_cpu.n_stalls:
            fail(f"cross-check {policy}: latency err {err}, stalls "
                 f"{n_stalls} vs {r_cpu.n_stalls}")
        report[f"cross_{policy}"] = {"max_abs_latency_err_s": err,
                                     "cpu_wall_s": w_cpu}
        print(f"cross-check {policy}: card vs cpu reads/probed identical, "
              f"max |latency err| {err:.3e} s (cpu run {w_cpu:.1f} s)",
              flush=True)

    prof = profile_main_path(torch, np, trace)
    report["profile_vlsm"] = prof
    print("profile vlsm: device busy "
          f"{prof['device_busy_ms']:.1f} ms of {prof['profiled_wall_s']:.2f} s "
          f"wall ({100 * prof['device_busy_share']:.2f}%)", flush=True)

    sources = {"merge_path": "kernels/merge_path/kernel.py:131",
               "overlap_scan": "kernels/overlap_scan/kernel.py:63",
               "lindley_scan": "kernels/lindley_scan/kernel.py:61"}
    rows = []
    for name, t in timings.items():
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/{sources[name]}",
            "launches": total[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"]})
    report["kernels"] = rows
    report["card"] = card
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
