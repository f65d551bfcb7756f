"""store_host_pct.replay: share of the replay's host time spent in the
store's mechanism and policies, in percent: ``core/lsm.py``,
``memtable.py``, ``sst.py``, ``merge.py``, ``level_index.py``,
``vsst.py`` and ``core/policies/``.

Stretch and attribution as ``des_host_pct.replay``: the one replay under
``cProfile``; own time plus built-ins charged to their caller's file.
"""

from port_bench.harness import host_share

FILES = tuple(f"repro_torch/core/{f}" for f in (
    "lsm.py", "memtable.py", "sst.py", "merge.py", "level_index.py",
    "vsst.py", "policies/"))


def read(art: dict) -> float | None:
    return host_share(art.get("host_profile"), FILES)
