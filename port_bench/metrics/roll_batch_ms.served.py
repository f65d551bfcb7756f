"""roll_batch_ms.served: median wall time of the served batches that
rolled a memtable (flush and compaction inside
``ShardedStore._roll_memtable``), in ms, seen from outside as growth of
``store.job_log`` during the batch.

Stretch: the plain first half of the traced run (no profiler), each batch
timed from its call to the synchronize after it.
"""

import numpy as np


def read(art: dict) -> float | None:
    walls = art.get("batch_walls_s")
    if walls is None:
        return None
    rolled = walls[art["batch_rolled"]]
    return float(np.median(rolled)) * 1e3 if rolled.size else None
