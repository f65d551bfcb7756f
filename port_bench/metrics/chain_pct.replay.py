"""chain_pct.replay: the wall time of the compaction chains, in percent of
the device-traced stretch: the union of the program's ``store.chain``
spans (``LSMTree._chain_pass``, one per chain, each run inside a flush or
the background triggers of a fill event) over the stretch's length.

Stretch: the replays under the device trace; the count of chains read
goes to standard error.  Without ``store.chain`` spans nothing is read.
"""

import sys


def read(art: dict) -> float | None:
    trace = art.get("device_trace")
    if trace is None or trace.window_s <= 0:
        return None
    chains = sorted((a, b) for a, b, n in trace.host if n == "store.chain")
    if not chains:
        return None
    covered, end = 0.0, float("-inf")
    for a, b in chains:
        if b > end:
            covered += b - max(a, end)
            end = b
    print(f"chain_pct: {len(chains)} store.chain spans over "
          f"{trace.window_s:.6f} s", file=sys.stderr)
    return 100.0 * covered / trace.window_s
