"""launches_per_kop.served: ``launches_per_kop.replay``'s reading, over
every op of the served cells' traced run."""

from port_bench.harness import metric_reader

read = metric_reader("launches_per_kop.replay")
