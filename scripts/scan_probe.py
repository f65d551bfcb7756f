#!/usr/bin/env python3
"""Short chip runs for iterating on two kernels of the PyTorch/CUDA port,
overlap_scan (the store's sorted-array rank) and ssd_scan (the Mamba2
scan), on one GPU.

    python3 scripts/scan_probe.py checks            # build, check, sweep
    python3 scripts/scan_probe.py times [--src DIR] # the timed shapes only
    python3 scripts/scan_probe.py ssd               # ssd_scan only

``checks`` builds both kernels, prints their ``-Xptxas -v`` lines, holds
each against its plain version (overlap_scan exactly, also against
``torch.searchsorted``; ssd_scan's y and final state within
``chip_smoke.TOL``) at small and real shapes, printing every failure
instead of stopping at the first, then times both wrappers at their timed
shapes.  ``times`` runs only the wrapper timings, through whichever
``repro_torch`` is first on the path (``--src`` puts a directory, such as
an unpacked parent commit's ``src``, first), so two versions can be timed
in turns within one call.  ``ssd`` runs ssd_scan's checks and timings
alone, with its kernels' own times from torch.profiler.  Inputs and
timings come from ``chip_smoke.py``'s functions; ``--out DIR`` also
writes every number to ``DIR/scan_probe-<mode>.json``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank_inputs(torch, np):
    """The store's main rank shape without replaying the store: the unique
    keys of the 8 M uniform load as fences, the first memtable's worth
    (41,943) of YCSB A's Zipfian GET keys."""
    from repro_torch.bench_kv.workloads import load_keys, make_run_a
    pop = np.unique(load_keys(8_000_000, seed=7))
    spec = make_run_a(pop, 200_000, dist="zipfian")
    gets = spec.keys[spec.op_types == 1][:41_943]
    return (torch.from_numpy(pop).to("cuda"),
            torch.from_numpy(np.ascontiguousarray(gets)).to("cuda"))


def checks(torch, np, cs, out) -> int:
    from repro_torch.kernels.overlap_scan import ops as rank_ops
    bad = 0
    rng = np.random.default_rng(1)
    lo, hi = -2 ** 63, 2 ** 63 - 1
    top = 2 ** 12 - 1
    keys = np.concatenate([[lo, hi, lo + 1, hi - 1, 0, 3, 9],
                           rng.integers(-5000, 5000, 3001)]).astype(np.int64)
    sizes = [0, 1, 2, 17, top - 1, top, top + 1, top + 2, 6143, 6144, 6145,
             100_000, 1_000_003]
    fence_sets = [np.sort(rng.integers(-4000, 4000, s)) for s in sizes]
    fence_sets += [np.array([lo] * 50 + [3] * 5000 + [hi] * 90, np.int64),
                   np.array([lo, 0, hi], np.int64)]
    for fences in fence_sets:
        f = torch.tensor(fences, device="cuda")
        for m in (1, 255, 257, 1025, keys.size):
            k = torch.tensor(keys[:m], device="cuda")
            for side in ("right", "left"):
                try:
                    got = rank_ops.fence_rank(f, k, side)
                    want = torch.searchsorted(f, k, side=side)
                    if not torch.equal(got, want) or not torch.equal(
                            got, rank_ops.fence_rank_plain(f, k, side)):
                        bad += 1
                        print(f"FAIL rank n={fences.size} m={m} {side}: "
                              f"{int((got != want).sum())} differ",
                              flush=True)
                except Exception:
                    bad += 1
                    traceback.print_exc()
    f = torch.tensor(fence_sets[6], device="cuda")
    k = torch.tensor(keys, device="cuda").view(-1, 2)[:, 1]
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got = rank_ops.fence_rank(f, k, "left")
    s.synchronize()
    if not torch.equal(got, torch.searchsorted(f, k.contiguous(),
                                               side="left")):
        bad += 1
        print("FAIL rank: strided keys on a side stream", flush=True)
    print(f"rank checks done, bad {bad}", flush=True)
    bad += ssd_checks(torch, cs)
    bad += times(torch, np, cs, out)
    return bad


def ssd_checks(torch, cs) -> int:
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    bad = 0
    worst = 0.0
    cases = [(2, L, 4, g, n, p, dt, strided)
             for L in (1, 63, 64, 65, 128, 189, 300)
             for g in (1, 2) for n, p in ((64, 64), (128, 64), (16, 32),
                                          (64, 48))
             for dt in ("float32", "bfloat16") for strided in (False, True)]
    cases += [(1, 189, 64, 1, 64, 64, dt, True)
              for dt in ("bfloat16", "float32")]
    cases += [(1, 4096, 64, 1, 64, 64, dt, True)
              for dt in ("bfloat16", "float32")]
    cases += [(2, 4096, 8, 2, 64, 64, "bfloat16", False)]
    for b, L, h, g, n, p, dt, strided in cases:
        what = f"ssd B={b} L={L} H={h} G={g} N={n} P={p} {dt} " \
               f"strided={strided}"
        try:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(L + n + p)
            args = cs.ssd_inputs(torch, gen, b, L, h, g, n, p,
                                 getattr(torch, dt), strided)
            y, st = ssd_scan(*args)
            torch.cuda.synchronize()
            y_w, st_w = ssd_scan_plain(*args)
            for name, got, want, tol in (
                    ("y", y, y_w, cs.TOL["ssd_scan", dt]),
                    ("state", st, st_w, cs.SSD_STATE_TOL)):
                atol, rtol = tol
                gf, wf = got.float(), want.float()
                err = float((gf - wf).abs().max())
                if name == "y":
                    worst = max(worst, err)
                if not (got.shape == want.shape and got.dtype == want.dtype
                        and bool(gf.isfinite().all())
                        and bool(((gf - wf).abs()
                                  <= atol + rtol * wf.abs()).all())):
                    bad += 1
                    print(f"FAIL {what} {name}: max err {err}, max|want| "
                          f"{float(wf.abs().max())}", flush=True)
        except Exception:
            bad += 1
            print(f"EXC {what}", flush=True)
            traceback.print_exc()
    print(f"ssd checks done, worst y err {worst}, bad {bad}", flush=True)
    return bad


def ssd(torch, np, cs, out) -> int:
    """ssd_scan's checks and its timings only."""
    return ssd_checks(torch, cs) + times(torch, np, cs, out, rank=False)


def times(torch, np, cs, out, rank: bool = True) -> int:
    """Wrapper, plain and library times at the timed shapes, through the
    API both the parent's and this version take."""
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    bad = 0
    for L in (189, 4096):
        bad += time_ssd(torch, cs, out, L, ssd_scan, ssd_scan_plain)
    if not rank:
        return bad
    fences, gets = rank_inputs(torch, np)
    ok = torch.equal(fence_rank(fences, gets, "left"),
                     torch.searchsorted(fences, gets, side="left"))
    bad += not ok
    r = out["rank_main"] = {
        "ok": ok, **cs.time_all(
            torch, lambda: fence_rank(fences, gets, "left"),
            lambda: fence_rank_plain(fences, gets, "left"),
            lambda: torch.searchsorted(fences, gets, side="left"), 200)}
    print("rank main", json.dumps(r), flush=True)
    for m, n in ((1, 4096), (1, 300_000), (64, 7_956_248)):
        f = fences[torch.linspace(0, fences.shape[0] - 1, n,
                                  device="cuda").long()]
        k = gets[:m].contiguous()
        r = out[f"rank_{m}x{n}"] = cs.time_all(
            torch, lambda: fence_rank(f, k, "left"), None,
            lambda: torch.searchsorted(f, k, side="left"), 200)
        print(f"rank {m} keys over {n}", json.dumps(r), flush=True)
    return bad


def time_ssd(torch, cs, out, L, ssd_scan, ssd_scan_plain) -> int:
    """zamba2-1.2b's scan at L tokens (B 1, 64 heads of P 64, N 64, bf16,
    strided views of one xbc buffer): times and the kernels' own times."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    args = cs.ssd_inputs(torch, gen, 1, L, 64, 1, 64, 64, torch.bfloat16,
                         strided=True, dt_range=(-2, 0.5))
    y, st = ssd_scan(*args)
    y_w, st_w = ssd_scan_plain(*args)
    err = float((y.float() - y_w.float()).abs().max())
    r = out[f"ssd_{L}"] = {
        "max_abs_err": err, "state_err": float((st - st_w).abs().max()),
        **cs.time_all(torch, lambda: ssd_scan(*args),
                      lambda: ssd_scan_plain(*args), None,
                      40 if L < 1000 else 10)}
    print(f"ssd L={L}", json.dumps(r), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd_scan(*args)
        torch.cuda.synchronize()
    r["kernels_us"] = {
        "".join(re.findall(r"chunk_out<[^>]*>|chunk_state|state_pass|"
                           r"ssd_fwd|elementwise|Memcpy", n)[:1]) or n[:40]:
        us / 10 for n, us, _ in cs.kernel_times_us(prof)}
    print(f"ssd L={L} by kernel, us per call", json.dumps(r["kernels_us"]),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("checks", "times", "ssd"))
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch to time")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the JSON report")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card_line(), "src", args.src, flush=True)
    t0 = time.time()
    try:
        _build.build(("overlap_scan", "ssd_scan"))
    finally:
        for name, log in _build.ptxas_reports.items():
            print(f"== {name} ==\n" + "\n".join(
                ln for ln in log.splitlines()
                if "Used" in ln or "error" in ln.lower()
                or "warning" in ln.lower() or "spill" in ln), flush=True)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    out: dict = {"card": cs.card_line(), "src": str(args.src)}
    bad = {"checks": checks, "times": times, "ssd": ssd}[args.mode](
        torch, np, cs, out)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        tag = args.mode if args.src == ROOT / "src" else \
            f"{args.mode}-{args.src.parent.name}"
        (args.out / f"scan_probe-{tag}.json").write_text(
            json.dumps(out, indent=1, default=str))
    print("BAD", bad, flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
