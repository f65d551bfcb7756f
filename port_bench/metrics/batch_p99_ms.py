"""batch_p99_ms: the 99th percentile of every served batch's wall time,
in ms, counted over all batches of the stretch (NumPy's linear
percentile).  In the served cells a batch that rolls a memtable runs its
flush and compaction chain inline, so this is where compaction chains
show in wall time.

Stretch: the plain first half of the traced run, as
``roll_batch_ms.served``; the batch count is printed in the run's notes.
It is a per-layer metric and not an end-to-end one because its spread
from run to run on the card's shared host (14–38% between quartiles in
sets of six) would need a bound above the benchmark's largest, 25%.
"""

import numpy as np


def read(art: dict) -> float | None:
    walls = art.get("batch_walls_s")
    if walls is None or walls.size == 0:
        return None
    return float(np.percentile(walls, 99)) * 1e3
