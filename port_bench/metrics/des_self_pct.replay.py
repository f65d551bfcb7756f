"""des_self_pct.replay: the DES's own share of the device-traced stretch,
in percent: the summed self time of the program's ``des.*`` spans over the
stretch's length.

Stretch: the replays under the device trace.  Spans: the program's own
(``repro_torch.trace``), recorded by the same ``torch.profiler`` as the
device and kept in ``DeviceTrace.host``.  A span's self time is its
duration less the part of it covered by the program spans (``des.*`` and
``store.*``) nested directly inside it; the aten ops inside a span count
as its own work.  The count and the summed self time of each span name
read go to standard error.
Without program spans (a program that records none) nothing is read.
"""

import sys
from collections import Counter

PROGRAM = ("des.", "store.")


def self_times(trace) -> list[list]:
    """[name, self seconds] of every program span of ``trace``: spans nest
    on the one thread that drives the store, so each span's parent is the
    innermost open span that it starts inside."""
    spans = sorted(((a, b, n) for a, b, n in trace.host
                    if n.startswith(PROGRAM)), key=lambda s: (s[0], -s[1]))
    out: list[list] = []
    open_: list[tuple[float, int]] = []        # (end, index into out)
    for a, b, n in spans:
        while open_ and open_[-1][0] <= a:
            open_.pop()
        if open_:
            out[open_[-1][1]][1] -= b - a
        open_.append((b, len(out)))
        out.append([n, b - a])
    return out


def read(art: dict, prefix: str = "des.") -> float | None:
    trace = art.get("device_trace")
    if trace is None or trace.window_s <= 0:
        return None
    times = [(n, s) for n, s in self_times(trace) if n.startswith(prefix)]
    if not times:
        return None
    counts, self_s = Counter(), Counter()
    for n, s in times:
        counts[n] += 1
        self_s[n] += s
    print(f"{prefix}* self time over {trace.window_s:.6f} s (spans, self "
          f"s): " + ", ".join(f"{n} {counts[n]} {self_s[n]:.6f}"
                             for n in sorted(counts)), file=sys.stderr)
    return 100.0 * sum(self_s.values()) / trace.window_s
