"""Benchmark harnesses of the port: the YCSB workload generators, the
open-loop YCSB harness and db_bench's benches (``db_bench``)."""

from .db_bench import (chain_report, fill_sim, fillrandom, fleet_points,
                       fleet_sweep_bench, make_serve_spec, read_path,
                       seekrandom, serve_row, serve_sweep_bench,
                       shard_sweep, ycsb_a)
from .workloads import (WorkloadSpec, make_load_a, make_run_a, make_run_b,
                        make_run_c, make_run_d, make_run_e, pareto_keys,
                        zipf_keys)
from .ycsb import YCSBResult, run_ycsb, sustainable_throughput

__all__ = [
    "WorkloadSpec", "YCSBResult", "chain_report", "fill_sim", "fillrandom",
    "fleet_points", "fleet_sweep_bench", "make_load_a", "make_run_a",
    "make_run_b", "make_run_c", "make_run_d", "make_run_e",
    "make_serve_spec", "pareto_keys", "read_path", "run_ycsb",
    "seekrandom", "serve_row", "serve_sweep_bench", "shard_sweep",
    "sustainable_throughput", "ycsb_a", "zipf_keys",
]
