"""launches_per_kop.replay: the store's kernel launches per 1,000 ops, by
the program's own counters (``merge_two_runs``, ``fence_rank`` and
``lindley_batch`` ``.launches``), over every op of the traced run.
"""


def read(art: dict) -> float | None:
    if not art.get("ops") or "launches" not in art:
        return None
    return 1000.0 * sum(art["launches"].values()) / art["ops"]
