"""Readings that the limits of ``correct`` are set from (PERF.md, section
2): the program's numbers over many seeds, and the control's.

    python3 -m port_bench.limits --workload <name> --seeds 11,12,13 \
        --seconds 3 [--control 3] [--fault <name>]

runs the cell once a seed, in one process on the card: its set-up, a
window of ``--seconds``, then every comparison, and for the first
``--control`` seeds the same comparisons with the control in the
program's place (``Entry.check(control=True)``).  With ``--fault`` the
whole run goes with that fault of ``port_bench.faults`` planted.  Prints
one JSON line a seed.  The benchmark's own runs never run the control or
a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from port_bench import harness
from port_bench.faults import FAULTS


def readings(workload: str, seeds: list[int], seconds: float, control: int,
             compute_device: str = "cuda", traffic_override=None,
             scale=None, fault: str | None = None):
    """Yield one dict of readings a seed."""
    _cell, spec, traffic = harness.cell_files(workload)
    traffic = {**traffic, **(traffic_override or {})}
    harness.program_path()
    entry_cls = harness.entry_module(traffic["entry"]).Entry
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            entry = entry_cls(spec, traffic, seed,
                              compute_device=compute_device, scale=scale)
            got = entry.window(seconds)
            entry.collect()
        checks = entry.check()
        out = {"workload": workload, "seed": seed, "fault": fault,
               "program": {n: v for n, v, _l in checks},
               "limits": {n: lim for n, _v, lim in checks},
               "notes": {k: v for k, v in got.items()
                         if not isinstance(v, tuple)}}
        if i < control:
            out["control"] = {n: v for n, v, _l in entry.check(control=True)}
        out["wall_s"] = time.perf_counter() - t0
        del entry
        gc.collect()
        yield out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_bench.limits: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in readings(args.workload, seeds, args.seconds, args.control,
                        fault=args.fault):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
