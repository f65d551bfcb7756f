"""des_host_pct.replay: share of the replay's host time spent in the DES,
``repro_torch/core/sim.py``, in percent.

Stretch: the one replay that the traced run makes under ``cProfile``,
after its device-traced stretch.  Time: each function's own time, and each
built-in's (NumPy, torch) charged to the file of the function that called
it, over all host time of that replay.
"""

from port_bench.harness import host_share

FILES = ("repro_torch/core/sim.py",)


def read(art: dict) -> float | None:
    return host_share(art.get("host_profile"), FILES)
