"""lookup_ms.served: the median duration of the program's
``store.lookup`` spans (``LSMTree._lookup_batch``, one per GET batch of a
shard: memtables, L0 probes, a fence rank per level, the bloom screen and
the one copy back), in ms.

Stretch: the served batches under the device trace; the count of spans
read goes to standard error.  Without such spans nothing is read.
"""

import sys

import numpy as np


def read(art: dict, name: str = "store.lookup") -> float | None:
    trace = art.get("device_trace")
    if trace is None:
        return None
    durations = [b - a for a, b, n in trace.host if n == name]
    if not durations:
        return None
    print(f"{name}: median of {len(durations)} spans", file=sys.stderr)
    return float(np.median(durations)) * 1e3
