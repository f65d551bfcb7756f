"""device_idle_pct.served: ``device_idle_pct.replay``'s reading, over the
served cells' device-traced stretch."""

from port_bench.harness import metric_reader

read = metric_reader("device_idle_pct.replay")
