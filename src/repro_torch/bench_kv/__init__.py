"""Benchmark harnesses of the port: YCSB workload generators and the
open-loop YCSB harness."""
