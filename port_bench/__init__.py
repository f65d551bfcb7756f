"""The benchmark of the PyTorch/CUDA port ``repro_torch``: cells,
configurations, traffic and per-layer metrics found by name from
``BENCHMARK.json``; see ``port_bench.run``."""
