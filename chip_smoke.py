#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which must pass (any failure raises and exits non-zero):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   five kernels from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel) into ``build/repro_torch/``.
2. Kernel edge cases: every kernel against its plain PyTorch version on the
   card (merge and rank exactly, Lindley within 1e-9 s; flash_attention
   over S 1..384, head_dim 64/128, GQA and windows, and ssd_scan's y and
   final state over L 1..300, G < H, dt from 1e-4 to 10, every element
   within atol + rtol * |plain| as TOL below states).
3. Store path: ``Simulator.run`` on the card for vlsm and rocksdb at the
   paper's byte scale (64 MiB scale, ``DeviceModel.scaled(1.0)``, 200-byte
   pairs): 8,000,000 uniform keys loaded at 500,000 ops/s, a 10 s settle,
   then 2,000,000 YCSB Run A ops (50% GET / 50% update, Zipfian 0.99) at
   8,000 ops/s.  Launch counts are zeroed just before and read just after;
   merge_path, overlap_scan and lindley_scan must have launched.
4. Serving path: ``repro_torch.launch.serve.run("zamba2_1_2b",
   smoke=False)`` — zamba2-1.2b at full width and depth (38 Mamba2 layers,
   d_model 2048, the shared attention block applied 6 times), bf16 weights
   from a seeded generator, 8 requests (two shared 128-token prefixes plus
   8-63-token tails), 16 greedy tokens each, through the vLSM prefix cache.
   Launch counts are zeroed just before and read just after;
   flash_attention, ssd_scan and overlap_scan must have launched.
5. Kernel timings at the main paths' shapes: kernel, plain version and
   library call — ``ms``, the median of five CUDA-event-timed trials of
   back-to-back calls, and ``device_ms``, the kernels' own device time from
   torch.profiler — beside the bound: the larger of the bytes at 3.35 TB/s
   and the operations at 989 TFLOP/s (bf16).  The LM kernels are also
   timed at a 4,096-token prefill.
6. Cross-checks: the store path again with ``compute_device="cpu"`` (per-op
   reads/probed and stall counts identical, latency within 1e-9 s); the
   serving model in float32, full width, depth cut to 7 layers (one
   shared-attention application), card against CPU on the first request's
   prefill and 4 greedy decode steps (tokens identical, logits within
   1e-3 of max(1, max|logit|)).
7. Where the time goes: the vlsm store path under torch.profiler and
   cProfile; a 2-request serving run under torch.profiler.

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
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate
LINDLEY_TOL_S = 1e-9
# Kernel against plain version, element by element: |got - want| <= atol +
# rtol * |want|.  The atols are the reference's own (tests/test_kernels.py)
# except flash's bf16 one: both sides compute in fp32 from the same inputs
# (the bf16 kernel keeps P to ~16 bits) and round once to bf16, so they
# differ by at most one bf16 ulp (< 2^-7 |want|) and ~1e-4 before rounding.
# ssd's fp32 rtol covers its cumsums over 64- vs 128-step chunks: exponents
# up to ~700 carry ~1e-5 relative error into y (a CPU emulation of the
# kernel's chunking reaches a quarter of it).  The state is fp32 arithmetic
# in both dtypes and is never rounded to bf16.
TOL = {("flash_attention", "float32"): (2e-5, 0.0),
       ("flash_attention", "bfloat16"): (1e-3, 1e-2),
       ("ssd_scan", "float32"): (2e-4, 1e-4),
       ("ssd_scan", "bfloat16"): (6e-2, 1e-2)}
SSD_STATE_TOL = (2e-4, 1e-4)
SERVE_ARCH = "zamba2_1_2b"
SERVE_REQUESTS = 8             # serve.run's default, the reference's
PROFILE_REQUESTS = 2           # the profiled serving run (phase 7)
CROSS_LAYERS = 7               # depth of the float32 card-vs-CPU cross-check
CROSS_TOL = 1e-3               # of max(1, max|logit|), see serve_cross_check
LONG_PREFILL = 4096
STORE_KERNELS = ("merge_path", "overlap_scan", "lindley_scan")
SERVE_KERNELS = ("flash_attention", "ssd_scan", "overlap_scan")
SOURCES = {"merge_path": "kernels/merge_path/kernel.py:131",
           "overlap_scan": "kernels/overlap_scan/kernel.py:63",
           "lindley_scan": "kernels/lindley_scan/kernel.py:61",
           "flash_attention": "kernels/flash_attention/kernel.py:108",
           "ssd_scan": "kernels/ssd_scan/kernel.py:81"}
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


def roofline(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what sets it): bytes at 3.35 TB/s or bf16 operations at
    989 TFLOP/s, whichever takes longer."""
    b_ms, f_ms = bound_ms(nbytes), flops / BF16_FLOP_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


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


# ------------------------------------------------------ LM kernels: edges
def _randn(torch, gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_close(what: str, kernel: str, got, want, tol=None) -> float:
    """Fails unless dtype and shape match, got is finite and every element
    is within ``tol`` (default TOL[kernel, dtype]) of want; returns the
    largest |got - want|."""
    atol, rtol = tol or TOL[kernel, str(want.dtype).split(".")[1]]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    if not (got.dtype == want.dtype and got.shape == want.shape
            and bool(g.isfinite().all())
            and bool(((g - w).abs() <= atol + rtol * w.abs()).all())):
        fail(f"{what}: max |err| {err} (atol {atol}, rtol {rtol}, max|want| "
             f"{float(w.abs().max()) if w.numel() else 0.0})")
    return err


def edge_flash(torch) -> float:
    """flash_attention against its plain version: S 1, 127, 128, 130, 384;
    head_dim 64 and 128; GQA rep 1 and 2; window None and 128; fp32 and
    bf16; plus a non-causal case.  Returns the largest |err|."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    worst = 0.0
    cases = [(s, d, rep, win, dt, True)
             for s in (1, 127, 128, 130, 384) for d in (64, 128)
             for rep in (1, 2) for win in (None, 128)
             for dt in ("float32", "bfloat16")]
    cases += [(130, 64, 2, None, "float32", False),
              (384, 128, 1, 128, "bfloat16", False)]
    for s, d, rep, win, dt, causal in cases:
        dtype = getattr(torch, dt)
        q = _randn(torch, gen, (2, 2 * rep, s, d), dtype)
        k = _randn(torch, gen, (2, 2, s, d), dtype)
        v = _randn(torch, gen, (2, 2, s, d), dtype)
        got = flash_attention(q, k, v, causal=causal, window=win)
        want = flash_attention_plain(q, k, v, causal=causal, window=win)
        worst = max(worst, check_close(
            f"flash_attention edge case S={s} D={d} rep={rep} window={win} "
            f"{dt} causal={causal}", "flash_attention", got, want))
    return worst


def edge_ssd(torch) -> float:
    """ssd_scan against its plain version, y and final state: L 1, 100,
    128, 300 (padded as the reference pads); H 4 over G 1 and 2; (N, P)
    (64, 64), (128, 64), (16, 32) and (64, 48) (two, one and one column
    blocks per head); fp32 and bf16; dt log-uniform from 1e-4 to 10.
    Returns the largest |err| of y."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    worst = 0.0
    cases = [(L, g, n, p, dt) for L in (1, 100, 128, 300) for g in (1, 2)
             for n, p in ((64, 64), (128, 64), (16, 32), (64, 48))
             for dt in ("float32", "bfloat16")]
    for L, g, n, p, dt_name in cases:
        dtype = getattr(torch, dt_name)
        b, h = 2, 4
        x = _randn(torch, gen, (b, L, h, p), dtype)
        dt = (10.0 ** (torch.rand((b, L, h), generator=gen, device="cuda")
                       * 5 - 4)).to(dtype)
        a = -(torch.rand(h, generator=gen, device="cuda") + 0.1)
        bm = _randn(torch, gen, (b, L, g, n), dtype, 0.3)
        cm = _randn(torch, gen, (b, L, g, n), dtype, 0.3)
        worst = max(worst, check_ssd(
            f"ssd_scan edge case L={L} G={g} N={n} P={p} {dt_name}",
            ssd_scan(x, dt, a, bm, cm), ssd_scan_plain(x, dt, a, bm, cm)))
    return worst


def check_ssd(what: str, got, want) -> float:
    """y and the final state against the plain version's; returns the
    largest |err| of y."""
    (y, state), (y_want, state_want) = got, want
    check_close(f"{what}, final state", "ssd_scan", state, state_want,
                SSD_STATE_TOL)
    return check_close(what, "ssd_scan", y, y_want)


# --------------------------------------------------------- serving path
def serve_path(torch, np) -> dict:
    """The serving entry point at zamba2-1.2b's full size, with the
    reference's defaults (8 requests, 16 decode tokens, 32-token blocks,
    max_seq 512, 50 req/s offered, no admission limit)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    out = serve.run(SERVE_ARCH, smoke=False, compute_device="cuda")
    wall = time.perf_counter() - t0
    s = out["stats"]
    lens = [len(r) for r in serve.make_requests(SERVE_REQUESTS,
                                                cfg.vocab_size)]
    outs = out["outputs"]
    if not (len(outs) == s["requests_admitted"] == SERVE_REQUESTS
            and all(len(o) == 16 and all(0 <= t < cfg.vocab_size for t in o)
                    for o in outs)):
        fail("serving path: every request must get 16 tokens in the vocab")
    # two shared 128-token prefixes: every request after the first two
    # finds its prefix (four 32-token blocks) in the vLSM index
    if s["prefix_hits"] != SERVE_REQUESTS - 2 \
            or s["tokens_reused"] != 128 * (SERVE_REQUESTS - 2):
        fail(f"serving path: prefix hits {s['prefix_hits']}, reused "
             f"{s['tokens_reused']}")
    decoded = (16 - 1) * len(outs)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_dtype": cfg.param_dtype, "params": cfg.param_count(),
        "wall_s": wall, "requests_served": s["requests_admitted"],
        "requests_rejected": s["requests_rejected"],
        "prefix_hits": s["prefix_hits"], "tokens_reused": s["tokens_reused"],
        "prompt_tokens": lens, "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
        "latency_ms": s["latency_ms"], "prefill_ms": s["prefill_ms"],
        "decode_ms": s["decode_ms"],
        "prefill_tok_s": sum(lens) / (sum(s["prefill_ms"]) / 1e3),
        "prefill_tok_s_after_first": sum(lens[1:])
        / (sum(s["prefill_ms"][1:]) / 1e3),
        "decode_tok_s": decoded / (sum(s["decode_ms"]) / 1e3),
        "decode_ms_per_token_after_first": sum(s["decode_ms"][1:])
        / (15 * (len(outs) - 1)),
        "prefix_cache": s["prefix_cache"], "outputs": outs,
    }


def serve_cross_check(torch, np) -> dict:
    """The serving model in float32 at full width, depth cut to
    CROSS_LAYERS (7 keeps one shared-attention application), card against
    the CPU tier
    with the same weights: the first request's prefill and 4 greedy decode
    steps.  Tokens must be identical and logits within CROSS_TOL of
    max(1, max|logit|): fp32 sums over 2048-8192 terms taken in another
    order on each side (the smoke-size CPU parity, 128 wide, measured
    3.5e-6), while a wrong kernel moves logits by O(0.1)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import decode_step, forward, init_model
    cfg = get_config(SERVE_ARCH).with_(n_layers=CROSS_LAYERS,
                                       param_dtype="float32")
    params = init_model(cfg, 0, compute_device="cuda")

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    cpu_params = to_cpu(params)
    tokens = make_requests(SERVE_REQUESTS, cfg.vocab_size)[0]
    runs = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        logits, cache = forward(cfg, p, {"tokens": tokens[None]},
                                cache_len=512, compute_device=dev)
        steps = [logits.float().cpu()]
        tok = torch.argmax(logits[:, -1:], -1)
        toks = [int(tok[0, 0])]
        pos = torch.tensor([len(tokens)], device=dev)
        for t in range(4):
            logits, cache = decode_step(cfg, p, tok, pos + t, cache,
                                        compute_device=dev)
            steps.append(logits.float().cpu())
            tok = torch.argmax(logits[:, -1:], -1)
            toks.append(int(tok[0, 0]))
        runs[dev] = (steps, toks, time.perf_counter() - t0)
    (c_steps, c_toks, c_wall), (h_steps, h_toks, h_wall) = \
        runs["cuda"], runs["cpu"]
    errs = [float((a - b).abs().max()) for a, b in zip(c_steps, h_steps)]
    scale = max(1.0, max(float(b.abs().max()) for b in h_steps))
    if c_toks != h_toks or max(errs) > CROSS_TOL * scale:
        fail(f"serving cross-check: tokens {c_toks} vs {h_toks}, logits "
             f"max |err| per step {errs} (scale {scale})")
    return {"layers": CROSS_LAYERS, "prompt_tokens": len(tokens),
            "tokens": c_toks, "max_abs_logit_err": errs,
            "max_abs_logit": scale, "card_s": c_wall, "cpu_s": h_wall}


# ----------------------------------------------------- LM kernel timings
def flash_bound(bh: int, s: int, d: int, nbytes_el: int = 2):
    """q, k, v read and o written once; 4*D operations per unmasked
    (query, key) pair, S(S+1)/2 pairs per head (causal)."""
    return roofline(4 * bh * s * d * nbytes_el, 2 * d * s * (s + 1) * bh)


def ssd_bound(b: int, L: int, h: int, g: int, n: int, p: int,
              nbytes_el: int = 2):
    """x, dt, B, C read and y written once, the fp32 final state written
    once (a negligible); the recurrence's 4*N*P operations per step and
    head (state update and readout)."""
    nbytes = nbytes_el * (2 * b * L * h * p + b * L * h + 2 * b * L * g * n) \
        + 4 * b * h * n * p
    return roofline(nbytes, 4 * n * p * L * b * h)


def time_flash(torch, s: int, reps: int) -> dict:
    """zamba2-1.2b's shared attention prefill: B 1, 32 heads (kv 32), D 64,
    bf16, causal, at S tokens (seeded random inputs)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q, k, v = (_randn(torch, gen, (1, 32, s, 64), torch.bfloat16)
               for _ in range(3))
    err = check_close(f"flash_attention at S={s}", "flash_attention",
                      flash_attention(q, k, v), flash_attention_plain(q, k, v))
    bound, by = flash_bound(32, s, 64)
    return {"shape": f"BH 32, S {s}, D 64, bf16, causal",
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            **time_all(torch, lambda: flash_attention(q, k, v),
                       lambda: flash_attention_plain(q, k, v),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True), reps)}


def time_ssd(torch, L: int, reps: int) -> dict:
    """zamba2-1.2b's Mamba2 prefill: B 1, 64 heads of P 64, one group of
    N 64, bf16, at L tokens (padded by the wrapper as the reference pads;
    seeded random inputs, dt in the softplus range)."""
    from repro_torch.kernels.ssd_scan.ops import (DEFAULT_CK, _chunk,
                                                  ssd_scan, ssd_scan_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    bf = torch.bfloat16
    x = _randn(torch, gen, (1, L, 64, 64), bf)
    dt = torch.nn.functional.softplus(
        torch.randn((1, L, 64), generator=gen, device="cuda")).to(bf)
    a = -torch.ones(64, device="cuda")
    bm = _randn(torch, gen, (1, L, 1, 64), bf, 0.3)
    cm = _randn(torch, gen, (1, L, 1, 64), bf, 0.3)
    err = check_ssd(f"ssd_scan at L={L}", ssd_scan(x, dt, a, bm, cm),
                    ssd_scan_plain(x, dt, a, bm, cm))
    bound, by = ssd_bound(1, L, 64, 1, 64, 64)
    ckk, pad = _chunk(L, DEFAULT_CK)
    return {"shape": f"BH 64, L {L} (padded {L + pad}), P 64, N 64, bf16",
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            **time_all(torch, lambda: ssd_scan(x, dt, a, bm, cm),
                       lambda: ssd_scan_plain(x, dt, a, bm, cm), None,
                       reps)}


def profile_serve(torch, np) -> dict:
    """A 2-request full-size serving run under torch.profiler: the
    device's busy time by kernel against the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(SERVE_ARCH, smoke=False, n_requests=PROFILE_REQUESTS,
                  compute_device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_times_us(prof)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    return {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "top_device": [{"name": n[:90], "ms": us / 1e3, "count": c}
                           for n, us, c in rows[:15]]}


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
                "lindley_scan": edge_lindley(torch, np, rng),
                "flash_attention": edge_flash(torch),
                "ssd_scan": edge_ssd(torch)}
    torch.cuda.synchronize()
    print("kernel edge cases: merge_path and overlap_scan exact, "
          f"lindley_scan max |err| {edge_err['lindley_scan']:.3e} s, "
          f"flash_attention {edge_err['flash_attention']:.3e}, "
          f"ssd_scan {edge_err['ssd_scan']:.3e}", flush=True)

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
        if min(launches[policy][k] for k in STORE_KERNELS) <= 0:
            fail(f"{policy}: a kernel never launched on the store path")
    total = kernels.launch_counts()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    srv = serve_path(torch, np)
    serve_launches = kernels.launch_counts()
    srv["launches"] = serve_launches
    srv["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["serve"] = srv
    print("serving path: " + json.dumps(
        {k: v for k, v in srv.items() if k != "outputs"}), flush=True)
    if min(serve_launches[k] for k in SERVE_KERNELS) <= 0:
        fail(f"serving path: a kernel never launched: {serve_launches}")
    torch.cuda.empty_cache()

    sim, res = runs["vlsm"]
    timings = {"merge_path": time_merge(torch, sim),
               "overlap_scan": time_rank(torch, np, sim, trace),
               "lindley_scan": time_lindley(torch, np, sim, res)}
    del runs, sim, res
    s_serve = max(srv["prompt_tokens"])
    timings["flash_attention"] = time_flash(torch, s_serve, 40)
    timings["ssd_scan"] = time_ssd(torch, s_serve, 40)
    for name, err in edge_err.items():
        timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"], err)
    report["long_prefill"] = {
        "flash_attention": time_flash(torch, LONG_PREFILL, 10),
        "ssd_scan": time_ssd(torch, LONG_PREFILL, 10)}
    for name, t in timings.items():
        print(f"timing {name}: " + json.dumps(t), flush=True)
    for name, t in report["long_prefill"].items():
        print(f"timing {name} at {LONG_PREFILL} tokens: " + json.dumps(t),
              flush=True)
    torch.cuda.empty_cache()

    cross = serve_cross_check(torch, np)
    report["cross_serve"] = cross
    print("cross-check serving (float32, " f"{cross['layers']} layers): "
          + json.dumps(cross), flush=True)

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

    sprof = profile_serve(torch, np)
    report["profile_serve"] = sprof
    print("profile serving (2 requests): device busy "
          f"{sprof['device_busy_ms']:.1f} ms of {sprof['profiled_wall_s']:.2f}"
          f" s wall ({100 * sprof['device_busy_share']:.2f}%)", flush=True)

    rows = []
    for name, t in timings.items():
        # launches: each kernel's count on its own main path (store kernels
        # on the store path, the LM kernels on the serving path)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/{SOURCES[name]}",
            "launches": (total if name in STORE_KERNELS
                         else serve_launches)[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
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
