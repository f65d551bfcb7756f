"""roll_ms.served: the median duration of the program's ``store.roll``
spans (``ShardedStore._roll_memtable``: seal, flush, the chains they
trigger and the background triggers), in ms, read as ``lookup_ms.served``
reads ``store.lookup``."""

from port_bench.harness import metric_reader

_median_ms = metric_reader("lookup_ms.served")


def read(art: dict) -> float | None:
    return _median_ms(art, name="store.roll")
