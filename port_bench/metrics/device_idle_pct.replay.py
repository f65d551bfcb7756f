"""device_idle_pct.replay: share of the device-traced stretch in which no
operation ran on the card, in percent: the stretch's length less the union
of the device intervals of the ``torch.profiler`` trace, over the
stretch's length.
"""


def read(art: dict) -> float | None:
    trace = art.get("device_trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (trace.window_s - trace.busy_s()) / trace.window_s
