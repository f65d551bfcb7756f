"""What every entry of the benchmark shares: finding a cell's files by
name, building the store's configuration from its file, the guard against
the JAX package, and the two instruments of a traced run (the device
trace from ``torch.profiler`` and the host profile from ``cProfile``).

Nothing here imports the program at module level; ``src`` of the checkout
is put on ``sys.path`` by :func:`program_path`.
"""

from __future__ import annotations

import cProfile
import contextlib
import importlib.util
import json
import os
import pstats
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------- the files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of ``workload``, found by name."""
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    spec = load_json(root / config["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, spec, traffic


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "port_bench.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_module(name: str):
    return importlib.import_module(f"port_bench.entries.{name}")


def program_path(root: Path = ROOT) -> None:
    """Put the checkout's ``src`` first on ``sys.path``: the program is
    run from the tree it is checked out in, never from an installation."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


# ------------------------------------------------- the store's configuration
#: LSMConfig fields a configuration file states, as run.
LSM_FIELDS = ("kv_size", "memtable_size", "max_write_buffers", "sst_size",
              "l0_max_ssts", "l0_stop_ssts", "growth_factor", "phi",
              "max_levels", "debt_factor", "bloom_fpr", "block_size",
              "n_shards", "chain_aware_sched")
DEVICE_FIELDS = ("write_bw", "read_bw", "io_latency", "block_size",
                 "compaction_slots")


def lsm_config(spec: dict, scale: int | None = None):
    """The policy's own configuration at the file's byte scale, held to
    every number the file states (a mismatch stops the run: the file must
    say what is run).  ``scale`` replaces the file's for CPU tests; the
    sizes that follow from it are then not held."""
    from repro_torch.core import get_policy
    cfg = get_policy(spec["policy"]).default_config(
        scale=spec["scale"] if scale is None else scale)
    if cfg.policy != spec["policy"]:
        raise SystemExit(f"port_bench: policy {cfg.policy!r} is run, the "
                         f"file states {spec['policy']!r}")
    scaled = ("memtable_size", "sst_size") if scale is not None else ()
    for key in LSM_FIELDS:
        if key in scaled:
            continue
        if getattr(cfg, key) != spec["lsm"][key]:
            raise SystemExit(f"port_bench: {spec['name']}: {key} is "
                             f"{getattr(cfg, key)!r} as run, the file states "
                             f"{spec['lsm'][key]!r}")
    return cfg


def device_model(spec: dict):
    from repro_torch.core import DeviceModel
    dev = DeviceModel.scaled(spec["device_scale"])
    for key in DEVICE_FIELDS:
        if getattr(dev, key) != spec["device_model"][key]:
            raise SystemExit(f"port_bench: {spec['name']}: device {key} is "
                             f"{getattr(dev, key)!r} as run, the file "
                             f"states {spec['device_model'][key]!r}")
    return dev


# ------------------------------------------------------------- the guard
def forbidden_loaded() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name (before the first
    dot) is, whole, one of jax, jaxlib, flax or the JAX package repro."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


# ------------------------------------------------------------ the host
def host_cpu_s() -> float:
    """CPU seconds that this process has used so far, in all its threads
    (read around the window for a result line's notes, never a metric)."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def host_probe_s() -> float:
    """Seconds that a fixed piece of host work takes (three sorts of a
    million doubles and a Python loop), run after the window: how fast
    the host ran this process then."""
    import numpy as np
    a = np.random.default_rng(0).random(1 << 20)
    t0 = time.perf_counter()
    for _ in range(3):
        np.sort(a)
    x = 0
    for i in range(300_000):
        x += i & 7
    return time.perf_counter() - t0


# ---------------------------------------------------------- the device
def card() -> dict:
    """The card's name and count as torch sees them, and its power limit
    as nvidia-smi reads it (None when it cannot)."""
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
        out["power_limit"] = line
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


# ------------------------------------------------------ the device trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class DeviceTrace:
    """The device's activity in one traced stretch: the stretch's length
    on the trace's clock, every device interval inside it, and the host
    ops and annotations, to name the idle gaps by."""

    window_s: float
    intervals: list[tuple[float, float, str]]      # (start, end, name), s
    host: list[tuple[float, float, str]] = field(default_factory=list)

    def busy_s(self) -> float:
        """Length of the union of the device intervals."""
        busy, end = 0.0, -1.0
        for a, b, _ in sorted(self.intervals):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels named ``names``: a name matches
        a demangled signature whose function, after any namespace, is it
        (``(anonymous namespace)::merge_path_kernel(long const*, ...)``)."""
        pat = re.compile(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(
            re.escape(k) for k in names))
        return sum(b - a for a, b, n in self.intervals if pat.search(n))

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for a, b, n in self.intervals:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda t: -t[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps with no device work, each named by the
        host's innermost op or annotation at its middle."""
        gaps, end = [], 0.0
        for a, b, _ in sorted(self.intervals):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            covering = [(s, e, n) for s, e, n in self.host if s <= mid <= e]
            names = [n for _s, _e, n in sorted(covering)]
            out.append(["/".join(names[-2:]) if names else "host",
                        b - a])
        return out


@contextlib.contextmanager
def device_trace(into: dict, on_card: bool = True,
                 label: str = "port_bench.window"):
    """Trace the block with ``torch.profiler`` (CPU and, ``on_card``,
    CUDA); on exit put a :class:`DeviceTrace` of the block at
    ``into["device_trace"]``.  The chrome trace is written to ``TMPDIR``
    and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    sync = lambda: None  # noqa: E731
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        sync = torch.cuda.synchronize
    sync()
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_json(Path(path))
    finally:
        os.unlink(path)
    into["device_trace"] = reduce_trace(events, label)


def reduce_trace(events: dict, label: str) -> DeviceTrace:
    """The :class:`DeviceTrace` of a chrome trace, clipped to the span of
    the annotation ``label`` (times in seconds from its start)."""
    evs = events["traceEvents"] if isinstance(events, dict) else events
    win = [e for e in evs if e.get("ph") == "X" and e.get("name") == label
           and e.get("cat") in HOST_CATS]
    if not win:
        raise RuntimeError(f"port_bench: the trace has no span {label!r}")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev, host = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b <= t0 or a >= t1:
            continue
        a, b = max(a, t0), min(b, t1)
        item = ((a - t0) * 1e-6, (b - t0) * 1e-6, str(e.get("name", "")))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") in HOST_CATS and e.get("name") != label:
            host.append(item)
    return DeviceTrace((t1 - t0) * 1e-6, dev, host)


# -------------------------------------------------------- the host profile
@contextlib.contextmanager
def host_profile(into: dict):
    """Profile the block with ``cProfile``; on exit put at
    ``into["host_profile"]`` the seconds of host time attributed to each
    source file and the total.  A function's own time goes to its file; a
    built-in's (a NumPy or torch call) to the file of the function that
    called it, edge by edge."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        yield
    finally:
        prof.disable()
    wall = time.perf_counter() - t0
    by_file: dict[str, float] = {}
    total = 0.0
    for (file, _line, _fn), (_cc, _nc, tt, _ct, callers) in \
            pstats.Stats(prof).stats.items():
        total += tt
        if file != "~":
            by_file[file] = by_file.get(file, 0.0) + tt
            continue
        for (c_file, _l, _f), edge in callers.items():
            by_file[c_file] = by_file.get(c_file, 0.0) + edge[2]
    into["host_profile"] = {"by_file": by_file, "total_s": total,
                            "wall_s": wall}


def host_share(profile: dict, parts: tuple[str, ...]) -> float | None:
    """Percent of the profiled host time attributed to files whose path
    contains one of ``parts`` (None without a profile)."""
    if not profile or profile["total_s"] <= 0:
        return None
    got = sum(s for f, s in profile["by_file"].items()
              if any(p in f.replace(os.sep, "/") for p in parts))
    return 100.0 * got / profile["total_s"]


def span(name: str):
    """A benchmark span around a call into the program, which names the
    device's idle gaps in a traced run (``torch.profiler``'s
    ``record_function``)."""
    from torch.profiler import record_function
    return record_function(name)


# ----------------------------------------------------------- the counters
def launches() -> dict[str, int]:
    """The program's own launch counters of the store's three kernels."""
    from repro_torch.kernels.lindley_scan.ops import lindley_batch
    from repro_torch.kernels.merge_path.ops import merge_two_runs
    from repro_torch.kernels.overlap_scan.ops import fence_rank
    return {"merge_path": merge_two_runs.launches,
            "overlap_scan": fence_rank.launches,
            "lindley_scan": lindley_batch.launches}


def launch_delta(before: dict, after: dict) -> dict[str, int]:
    return {k: after[k] - before[k] for k in before}
