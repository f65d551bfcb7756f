"""store_self_pct.replay: the store's own share of the device-traced
stretch, in percent: the summed self time of the program's ``store.*``
spans (mechanism and policies) over the stretch's length, read as
``des_self_pct.replay`` reads the ``des.*`` spans."""

from port_bench.harness import metric_reader

_self_pct = metric_reader("des_self_pct.replay")


def read(art: dict) -> float | None:
    return _self_pct(art, prefix="store.")
