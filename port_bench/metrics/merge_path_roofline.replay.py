"""merge_path_roofline.replay: the compaction merges' share of their
roofline, in percent, against the H100's published 3.35 TB/s (the card's
power limit is in the result's ``device``).

Stretch: the replays under the device trace.  Bytes: 16 (an int64 key and
an int64 seqno) for each key read and each key written by the
compactions, counted once from the job ledger (``bytes_read`` and
``bytes_written`` over ``kv_size``); the keys written are held once to
``Stats.merged_keys`` and nothing is read when they differ.  Time: the
device time of the kernels named in ``KERNELS``.
"""

import sys

from port_bench.peaks import roofline_pct

KERNELS = ("merge_path_kernel",)
BYTES_PER_KEY = 16


def read(art: dict) -> float | None:
    trace = art.get("device_trace")
    if "compaction_bytes" not in art or trace is None:
        return None
    kv = art["kv_size"]
    bytes_read, bytes_written = art["compaction_bytes"]
    keys_read = int(bytes_read) // kv
    keys_written = int(bytes_written) // kv
    if keys_written != art["merged_keys"]:
        print(f"merge_path_roofline: the ledger's {keys_written} keys "
              f"written differ from Stats.merged_keys "
              f"{art['merged_keys']}", file=sys.stderr)
        return None
    return roofline_pct(BYTES_PER_KEY * (keys_read + keys_written),
                        trace.kernel_s(KERNELS))
