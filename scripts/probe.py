#!/usr/bin/env python3
"""Short chip runs of single phases of ``chip_smoke.py``, for iterating on
one kernel of the PyTorch/CUDA port without driving the store and serving
paths, on one GPU.

    python3 scripts/probe.py PHASE [PHASE ...] [--src DIR] [--out DIR]
                             [--predict TEXT]

Phases, each made of ``chip_smoke.py``'s own functions:

    edge_merge edge_rank edge_lindley edge_flash edge_ssd edge_paged
              one kernel's edge cases against its plain version
    states    zamba2-1.2b's bf16 prefill states and their hand-off to
              decode (``serve_state_check``)
    merge     merge_path at the store's main merge (an L1 run of 321,467
              keys with an L0 run of 22,578) and at its commonest
              (41,943 + 41,943), beside torch.sort
    rank      overlap_scan at 41,943 GET keys over 7,956,248 fences and at
              the commonest call (1 key over 6), beside torch.searchsorted
    lindley   lindley_scan over the store path's 10,000,000 arrivals (YCSB
              A's load and run, service exponential with a 20 us mean) as
              one queue and as 4,096 rows
    flash     flash_attention at S 189 (zamba2's and qwen3's heads) and at
              4,096
    paged     paged_attention at qwen3's and zamba2's decode shapes and at
              8 and 1 sequences of 4,096 tokens
    ssd       ssd_scan at zamba2's L 189 and 4,096
    seekrandom db_bench's seekrandom at full size for every policy, from
              rewound uid counters: its wall, its launches and its rows
    serve_sweep db_bench's serve_sweep at full size for every policy: its
              wall, its launches, its rows against the committed ones
    serve_open open-loop serving over the store at the paper's byte scale
              (``chip_smoke.py`` phase 3d, vlsm and rocksdb)
    shard_store ``ShardedStore`` of 4 shards and of 1 on the card against
              the CPU, and the 1 against a bare tree (``chip_smoke.py``
              phase 3e)
    window    ``device_ms`` read three times a function at the main
              shapes, with the device events each reading recorded
    clocks    merge_path's, lindley_scan's and ssd_scan's device time after
              an idle and after a busy second, beside the SM clock

It builds the kernels the phases need and prints their ``-Xptxas -v``
lines, prints ``--predict``'s text before anything runs, then runs every
phase even after one failed, printing each failure; the exit code is 1 if
any failed.  ``--src DIR`` puts another ``repro_torch`` first on the path
(such as an unpacked parent commit's ``src``), so two versions can be
timed in turns within one call; ``--out DIR`` writes every number to
``DIR/probe-<phases>[-<src>].json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_MERGE = (321_467, 22_578)     # an L1 run and an L0 run of the store
COMMON_MERGE = (41_943, 41_943)    # two flushed memtables
MAIN_RANK = (41_943, 7_956_248)    # a memtable of GETs over the flat L1
COMMON_RANK = (1, 6)


def _trace(ctx, np, cs):
    if "trace" not in ctx:
        ctx["trace"] = cs.ycsb_trace(np, cs.N_LOAD, cs.N_RUN)
    return ctx["trace"]


def merge(torch, np, cs, ctx) -> dict:
    trace = _trace(ctx, np, cs)
    return {"main": cs.time_merge_at(torch, np, trace, *MAIN_MERGE),
            "common": cs.time_merge_at(torch, np, trace, *COMMON_MERGE)}


def rank(torch, np, cs, ctx) -> dict:
    trace = _trace(ctx, np, cs)
    return {"main": cs.time_rank_at(torch, np, trace, *MAIN_RANK),
            "common": cs.time_rank_at(torch, np, trace, *COMMON_RANK)}


def lindley(torch, np, cs, ctx) -> dict:
    arrivals = _trace(ctx, np, cs)[2]
    service = np.random.default_rng(4).exponential(2e-5, arrivals.size)
    return {"queue": cs.time_lindley(torch, np, service, arrivals),
            "rows": cs.time_lindley_ragged(torch, np, arrivals,
                                           cs.LINDLEY_ROWS)}


def flash(torch, np, cs, ctx) -> dict:
    return {"zamba2_189": cs.time_flash(torch, 189, 40),
            "qwen3_189": cs.time_flash(torch, 189, 40, 16, 8, 128),
            "d64_4096": cs.time_flash(torch, cs.LONG_PREFILL, 10),
            "qwen3_4096": cs.time_flash(torch, cs.LONG_PREFILL, 10, 16, 8,
                                        128)}


def paged(torch, np, cs, ctx) -> dict:
    length = 189 + cs.DECODE_TOKENS - 1
    return {"qwen3_decode": cs.time_paged(torch, length, 200),
            "zamba2_decode": cs.time_paged(torch, length, 200, 32, 32, 64),
            "long_b8": cs.time_paged_long(torch, 20),
            "long_b1": cs.time_paged_long(torch, 40, 1)}


def ssd(torch, np, cs, ctx) -> dict:
    return {"L189": cs.time_ssd(torch, 189, 40),
            "L4096": cs.time_ssd(torch, cs.LONG_PREFILL, 10)}


def seekrandom(torch, np, cs, ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    from repro_torch.core.uids import reset_uid_counters
    reset_uid_counters()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = db_bench.main(["--bench", "seekrandom"])
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "launches": kernels.launch_counts(),
            "rows": [cs.strip_volatile(r) for r in rows]}


def serve_sweep(torch, np, cs, ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    want = [r for r in json.loads((ROOT / "BENCH_dbbench.json").read_text())
            if r["bench"] == "serve_sweep"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = db_bench.main(["--bench", "serve_sweep"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    flips: list = []
    got = [r for r in rows if r["bench"] == "serve_sweep"]
    if len(got) != len(want):
        cs.fail(f"serve_sweep: {len(got)} rows, {len(want)} committed")
    for i, (g, w) in enumerate(zip(got, want)):
        cs.compare_row(cs.strip_volatile(g), cs.strip_volatile(w),
                       f"{i}:serve_sweep:{w['policy']}", flips)
    return {"wall_s": wall, "launches": launches, "rows": len(got),
            "last_digit_flips": flips, "perf_trajectory": rows[-1]}


def serve_open(torch, np, cs, ctx) -> dict:
    memo: dict = {}
    return {p: cs.serve_open(torch, np, p, memo) for p in cs.SERVE_POLICIES}


def window(torch, np, cs, ctx) -> dict:
    """``device_ms`` read three times in a row for each function that
    merge_path's, overlap_scan's and lindley_scan's main shapes, ssd_scan
    and flash_attention at 4,096 tokens and paged_attention's long decode
    time, each reading with the device events torch.profiler recorded:
    how far the readings of one function spread within a call, and
    whether the profiler's window held every call's kernels."""
    from torch.profiler import ProfilerActivity, profile
    seen: list = []

    def device_ms(torch, fn, reps):
        fn()
        torch.cuda.synchronize()
        readings = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = cs.kernel_times_us(prof)
            readings.append({"ms": sum(us for _, us, _ in rows) / reps / 1e3,
                             "events": sum(c for _, _, c in rows),
                             "reps": reps})
        seen.append(readings)
        return (readings[0]["ms"] or None,
                readings[0]["events"] / readings[0]["reps"])

    out: dict = {"card_state": cs.card_query(cs.CARD_STATE)}
    trace = _trace(ctx, np, cs)
    service = np.random.default_rng(4).exponential(2e-5, trace[2].size)
    orig = cs.device_ms
    cs.device_ms = device_ms
    try:
        for name, run in (
                ("merge_main", lambda: cs.time_merge_at(torch, np, trace,
                                                        *MAIN_MERGE)),
                ("rank_main", lambda: cs.time_rank_at(torch, np, trace,
                                                      *MAIN_RANK)),
                ("lindley_queue", lambda: cs.time_lindley(
                    torch, np, service, trace[2])),
                ("ssd_4096", lambda: cs.time_ssd(torch, cs.LONG_PREFILL, 10)),
                ("flash_4096", lambda: cs.time_flash(torch, cs.LONG_PREFILL,
                                                     10)),
                ("paged_long_b8", lambda: cs.time_paged_long(torch, 20))):
            seen.clear()
            run()
            # one entry a time_all call: kernel, plain, library (if any)
            out[name] = list(seen)
    finally:
        cs.device_ms = orig
    return out


def clocks(torch, np, cs, ctx) -> dict:
    """The kernel's ``device_ms`` of merge_path's, lindley_scan's and
    ssd_scan's main calls, read after a second of an idle card and after a
    second of a busy one (bf16 products), twice each, over 50 times the
    smoke's calls, with the card's SM clock sampled every 10 ms by
    nvidia-smi during each reading and the mean kernel duration of the
    first and last tenth of the calls: whether the device time of a kernel
    whose wrapper leaves the card idle between calls follows the clock the
    card's power management picks."""
    import datetime
    import subprocess
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "10"],
        stdout=subprocess.PIPE, text=True)
    big = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    orig = cs.device_ms
    state: dict = {}

    def device_ms(torch, fn, reps):
        if state["readings"] is not None:
            return orig(torch, fn, reps)
        readings = state["readings"] = []
        for mode in ("idle", "busy", "idle", "busy"):
            torch.cuda.synchronize()
            end = time.perf_counter() + 1.0
            while time.perf_counter() < end:
                if mode == "busy":
                    big @ big
                    torch.cuda.synchronize()
                else:
                    time.sleep(0.01)
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(50 * reps):
                    fn()
                torch.cuda.synchronize()
            t1 = time.time()
            us = [e.time_range.elapsed_us() for e in sorted(
                (e for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", ""))),
                key=lambda e: e.time_range.start)]
            tenth = max(1, len(us) // 10)
            readings.append({
                "mode": mode, "t": (t0, t1), "calls": 50 * reps,
                "ms": sum(us) / (50 * reps) / 1e3, "events": len(us),
                "first_tenth_us": sum(us[:tenth]) / tenth,
                "last_tenth_us": sum(us[-tenth:]) / tenth})
        return readings[0]["ms"], readings[0]["events"] / readings[0]["calls"]

    out: dict = {}
    trace = _trace(ctx, np, cs)
    service = np.random.default_rng(4).exponential(2e-5, trace[2].size)
    cs.device_ms = device_ms
    try:
        for name, run in (
                ("merge_main", lambda: cs.time_merge_at(torch, np, trace,
                                                        *MAIN_MERGE)),
                ("lindley_queue", lambda: cs.time_lindley(
                    torch, np, service, trace[2])),
                ("ssd_4096", lambda: cs.time_ssd(torch, cs.LONG_PREFILL,
                                                 10))):
            state["readings"] = None
            run()
            out[name] = state["readings"]
    finally:
        cs.device_ms = orig
        time.sleep(0.1)
        smi.terminate()
    samples = []
    for line in smi.communicate()[0].splitlines():
        try:
            ts, mhz, util = (f.strip() for f in line.split(","))
            samples.append((datetime.datetime.strptime(
                ts, "%Y/%m/%d %H:%M:%S.%f").timestamp(), float(mhz),
                float(util)))
        except ValueError:
            continue
    for readings in out.values():
        for r in readings:
            t0, t1 = r.pop("t")
            mhz = sorted(m for t, m, _ in samples if t0 <= t <= t1)
            r["sm_mhz"] = ((mhz[0], mhz[len(mhz) // 2], mhz[-1])
                           if mhz else None)
            r["samples"] = len(mhz)
    out["samples"] = len(samples)
    return out


def shard_store(torch, np, cs, ctx) -> dict:
    want = {n: cs.shard_run(np, "cpu", n)[0] for n in (cs.SHARD_COUNT, 1)}
    return cs.shard_store_check(np, cs.shard_card_runs(torch, np), want)


STORE = ("merge_path", "overlap_scan", "lindley_scan")
# phase: (kernels it builds, what it runs)
PHASES = {
    "edge_merge": (("merge_path",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_merge(torch, np, np.random.default_rng(0))}),
    "edge_rank": (("overlap_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_rank(torch, np, np.random.default_rng(0))}),
    "edge_lindley": (("lindley_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_lindley(torch, np,
                                       np.random.default_rng(0))}),
    "edge_flash": (("flash_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_flash(torch)}),
    "edge_ssd": (("ssd_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_ssd(torch)}),
    "edge_paged": (("paged_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_paged(torch, np)}),
    "states": (("ssd_scan", "flash_attention", "paged_attention"),
               lambda torch, np, cs, ctx: cs.serve_state_check(torch, np)),
    "merge": (("merge_path",), merge),
    "rank": (("overlap_scan",), rank),
    "lindley": (("lindley_scan",), lindley),
    "flash": (("flash_attention",), flash),
    "paged": (("paged_attention",), paged),
    "ssd": (("ssd_scan",), ssd),
    "seekrandom": (STORE, seekrandom),
    "serve_sweep": (STORE, serve_sweep),
    "serve_open": (STORE, serve_open),
    "shard_store": (STORE, shard_store),
    "window": (STORE + ("flash_attention", "ssd_scan", "paged_attention"),
               window),
    "clocks": (STORE + ("ssd_scan",), clocks),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES),
                    metavar="PHASE", help=" ".join(PHASES))
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch to run")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the JSON report")
    ap.add_argument("--predict", default=None,
                    help="the run's prediction, printed before it runs")
    args = ap.parse_args()
    if args.predict:
        print("prediction:", args.predict, flush=True)
    import torch
    if not torch.cuda.is_available():
        print("probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card_line(), "src", args.src, flush=True)
    names = tuple(dict.fromkeys(k for p in args.phases for k in PHASES[p][0]))
    t0 = time.time()
    try:
        _build.build(names)
    finally:
        for name, log in _build.ptxas_reports.items():
            print(f"== {name} ==\n" + "\n".join(
                ln for ln in log.splitlines()
                if "Used" in ln or "error" in ln.lower()
                or "warning" in ln.lower() or "spill" in ln), flush=True)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    out: dict = {"card": cs.card_line(), "src": str(args.src)}
    ctx: dict = {}
    bad = 0
    for phase in args.phases:
        t0 = time.time()
        try:
            out[phase] = PHASES[phase][1](torch, np, cs, ctx)
            torch.cuda.synchronize()
            print(f"{phase}: ok in {time.time() - t0:.1f}s "
                  + json.dumps(out[phase], default=str), flush=True)
        except (Exception, SystemExit):     # a failed check exits via fail()
            bad += 1
            print(f"{phase}: FAILED", flush=True)
            traceback.print_exc()
            sys.stdout.flush()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        tag = "-".join(args.phases)
        if args.src != ROOT / "src":
            tag += f"-{args.src.resolve().parent.name}"
        (args.out / f"probe-{tag}.json").write_text(
            json.dumps(out, indent=1, default=str))
    print("BAD", bad, flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
