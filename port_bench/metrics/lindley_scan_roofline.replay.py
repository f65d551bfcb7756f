"""lindley_scan_roofline.replay: the DES's queue pass's share of its
roofline, in percent, against the H100's published 3.35 TB/s (the card's
power limit is in the result's ``device``).

Stretch: the replays under the device trace.  Bytes: 24 an op replayed
(its service and arrival read, its departure written, float64 each).
Time: the device time of the kernels named in ``KERNELS``.
"""

from port_bench.peaks import roofline_pct

KERNELS = ("lindley_tiles",)
BYTES_PER_OP = 24


def read(art: dict) -> float | None:
    trace = art.get("device_trace")
    if trace is None or not art.get("ops_traced"):
        return None
    return roofline_pct(BYTES_PER_OP * art["ops_traced"],
                        trace.kernel_s(KERNELS))
