"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It drives ``repro_torch`` (under ``src/``)
on the card, measures for ``--seconds`` after its set-up, checks what the
timed path produced against the NumPy reference in
``port_bench/reference``, and prints as the last line of its standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, every number compared beside its limit, which also end its
standard error.  It exits non-zero and prints no result without a card,
when a check cannot run, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):       # run as a file: the checkout's root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402


def _cells_metrics(bench: dict, kind: str, workload: str) -> list[dict]:
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             compute_device: str = "cuda", root: Path = harness.ROOT,
             traffic_override: dict | None = None,
             scale: int | None = None, spec_override: dict | None = None,
             t_start: float | None = None
             ) -> tuple[dict, list[tuple[str, float, float]], dict]:
    """Set up, measure and check one cell: (result line, checks, notes
    for an earlier line, such as the served batch count).  The
    CLI passes the card; tests pass ``compute_device="cpu"`` with a
    smaller traffic (``traffic_override``), byte ``scale`` and, to make
    a tiny store stall, a slower storage model (``spec_override``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = harness.benchmark(root)
    cell, spec, traffic = harness.cell_files(workload, root)
    if traffic["n_load"] != spec["population"]:
        raise SystemExit(f"port_bench: {workload}: the traffic loads "
                         f"{traffic['n_load']} keys, the configuration "
                         f"states a population of {spec['population']}")
    traffic = {**traffic, **(traffic_override or {})}
    spec = {**spec, **(spec_override or {})}
    harness.program_path(root)
    import torch
    parts = {"torch_import_s": time.perf_counter() - t_start}
    on_card = compute_device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    import repro_torch.core  # noqa: F401
    parts["cuda_init_and_program_import_s"] = \
        time.perf_counter() - t_start - parts["torch_import_s"]
    entry = harness.entry_module(traffic["entry"]).Entry(
        spec, traffic, seed, compute_device=compute_device, scale=scale)
    # what set-up made is not garbage: keep the collector's passes in the
    # window from walking it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    parts.update(entry.setup_parts)
    metrics: dict = {}
    breakdown = None
    device: dict = harness.card() if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    cpu_before = harness.host_cpu_s()
    if not trace:
        got = entry.window(seconds)
        for m in _cells_metrics(bench, "end_to_end", workload):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in got:
                value, unit = got[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
        notes = {k: v for k, v in got.items() if not isinstance(v, tuple)}
        notes["setup_parts"] = parts
    else:
        art = entry.traced(seconds)
        for m in _cells_metrics(bench, "per_layer", workload):
            value = harness.metric_reader(m["name"])(art)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = art.get("device_trace")
        if tr is not None:
            device["busy_s"] = tr.busy_s()
            device["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps()}
        notes = {"traced_ops": art.get("ops"), "setup_parts": parts}
        if "batches" in art:
            notes["batches"] = art["batches"]
    notes["host"] = {"cpu_s": harness.host_cpu_s() - cpu_before,
                     "probe_s": harness.host_probe_s()}
    if on_card:
        device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    t_check = time.perf_counter()
    entry.collect()
    gc.unfreeze()
    gc.collect()
    checks = entry.check()
    notes["check_s"] = time.perf_counter() - t_check
    correct = all(value <= limit for _n, value, limit in checks)
    result = {"correct": correct, "attempted": entry.attempted,
              "failed": entry.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks, notes


def pin_cpus() -> list[int]:
    """Keep the process, every thread it runs and every thread it starts
    after, on two fixed CPUs of those it may use (the second and the
    third), so that its host-bound work runs on the same cores from run to
    run instead of wherever the scheduler puts it (PERF.md, section 2).
    Returns the CPUs it runs on."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        if len(cpus) >= 3:
            cpus = cpus[1:3]
            for tid in os.listdir("/proc/self/task"):
                os.sched_setaffinity(int(tid), cpus)
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return []


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (harness.ROOT / "src" / "repro_torch").is_dir():
        print("port_bench: no src/repro_torch in this checkout",
              file=sys.stderr)
        return 2
    cell, _spec, _traffic = harness.cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cpus = pin_cpus()
    torch.set_num_threads(max(1, len(cpus)))
    result, checks, notes = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print("port_bench: the run loaded " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    notes["cpus"] = cpus
    print(json.dumps({"notes": notes}), flush=True)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
