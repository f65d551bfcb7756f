"""merge_step_roofline.replay: the whole merge step's share of its
roofline, in percent, against the H100's published 3.35 TB/s (the card's
power limit is in the result's ``device``).

Stretch: the replays under the device trace.  Bytes: as
``merge_path_roofline.replay``, 16 (an int64 key and an int64 seqno) for
each key read and each key written by the compactions, counted once from
the job ledger and held to ``Stats.merged_keys``.  Time: the device time
of every device interval (kernel, copy or set) that starts inside one of
the program's ``store.merge_runs`` spans (``LSMTree.merge_runs``: the
merge_path launches, ``dedup_latest``'s kernels and its copy).

An interval is placed by where it starts.  The device is idle most of the
stretch, so a kernel starts just after its launch; one launched inside a
span that starts only after the span has closed is missed, so where the
share errs, it mostly errs high.  The counts of spans and intervals read
go to standard error.  Without ``store.merge_runs`` spans nothing is read.
"""

import bisect
import sys

from port_bench.peaks import roofline_pct

BYTES_PER_KEY = 16


def read(art: dict) -> float | None:
    trace = art.get("device_trace")
    if "compaction_bytes" not in art or trace is None:
        return None
    spans = sorted((a, b) for a, b, n in trace.host
                   if n == "store.merge_runs")
    if not spans:
        return None
    kv = art["kv_size"]
    bytes_read, bytes_written = art["compaction_bytes"]
    keys_read = int(bytes_read) // kv
    keys_written = int(bytes_written) // kv
    if keys_written != art["merged_keys"]:
        print(f"merge_step_roofline: the ledger's {keys_written} keys "
              f"written differ from Stats.merged_keys "
              f"{art['merged_keys']}", file=sys.stderr)
        return None
    starts = [a for a, _b in spans]
    device_s, n_in = 0.0, 0
    for a, b, _n in trace.intervals:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < spans[i][1]:
            device_s += b - a
            n_in += 1
    print(f"merge_step_roofline: {len(spans)} store.merge_runs spans, "
          f"{n_in} device intervals starting inside them", file=sys.stderr)
    return roofline_pct(BYTES_PER_KEY * (keys_read + keys_written), device_s)
