"""read_batch_ms.served: median wall time of the served batches that
rolled no memtable, in ms: the read path (``LSMTree._lookup_batch``) and
the memtable inserts.

Stretch: the plain first half of the traced run, as
``roll_batch_ms.served``.
"""

import numpy as np


def read(art: dict) -> float | None:
    walls = art.get("batch_walls_s")
    if walls is None:
        return None
    plain = walls[~art["batch_rolled"]]
    return float(np.median(plain)) * 1e3 if plain.size else None
