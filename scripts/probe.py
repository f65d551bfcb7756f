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
