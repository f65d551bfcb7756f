#!/usr/bin/env python3
"""What one span of ``repro_torch.trace`` costs the host, off and on.

    python scripts/span_cost.py

Times ``with span(name): pass`` in a tight loop three ways: with no
profiler recording (the shared no-op: a flag read and a ``with``), the
same loop through an ungated ``record_function`` (what a span would cost
without the gate), and with ``torch.profiler`` recording, with the CUDA
activity too where a card is present, as the benchmark's traced runs
record.  Prints one JSON line: microseconds per span for each, the best
of five rounds, with the host's CPU and the card's name and power limit
beside them.  Multiply by the span counts of a traced run to get the
tracing's cost per replay or per batch.
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch.trace import span  # noqa: E402

ROUNDS = 5
N_OFF = 200_000     # spans a round with no profiler recording
N_ON = 20_000       # spans a round under the profiler


def _per_span_us(body, n: int) -> float:
    """Best of ``ROUNDS`` of ``body(n)``, in microseconds per span."""
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        body(n)
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / n


def _spans(n: int) -> None:
    for _ in range(n):
        with span("store.lookup"):
            pass


def _ungated(n: int) -> None:
    for _ in range(n):
        with record_function("store.lookup"):
            pass


def _card() -> dict:
    if not torch.cuda.is_available():
        return {"card": None}
    out = {"card": torch.cuda.get_device_name(0)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


def main() -> int:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.init()
    out = {"off_us": _per_span_us(_spans, N_OFF),
           "ungated_us": _per_span_us(_ungated, N_ON)}
    with profile(activities=activities):
        out["on_us"] = _per_span_us(_spans, N_ON)
    out.update({"activities": [a.name for a in activities],
                "cpu": platform.processor() or platform.machine(),
                "torch": torch.__version__, **_card()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
