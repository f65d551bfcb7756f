"""The program's spans (``repro_torch.trace``): a shared no-op without a
profiler, ``user_annotation`` ranges under one; their nesting in a tiny
replay and a tiny served run of the benchmark on the CPU; results equal
to the last bit with the profiler on and off; and the benchmark's six
readers of the spans on hand-built traces."""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness, run  # noqa: E402
from port_bench.harness import DeviceTrace  # noqa: E402
from port_bench.peaks import roofline_pct  # noqa: E402
from repro_torch import trace  # noqa: E402

# the benchmark's tiny CPU sizes (port_bench/tests/conftest.py)
SCALE = 1 << 20
TINY = {
    "replay": {"n_load": 30_000, "run_ops": 12_000},
    "served": {"n_load": 24_000, "pool_batches": 6, "batch_ops": 2_000,
               "load_batch": 7_000, "warm_batches": 2},
}
SEED = 2 ** 31 + 5


# ------------------------------------------------------------ the tracer
def test_span_without_profiler_is_the_shared_noop():
    assert autograd_profiler._is_profiler_enabled is False
    off = trace.span("a")
    assert off is trace.span("b")
    with off, trace.span("c"):      # nests and re-enters
        pass


def test_span_under_profiler_is_a_user_annotation(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled is True
        assert trace.span("a") is not trace.span("b")
        with trace.span("test.outer"):
            with trace.span("test.inner"):
                torch.ones(4).sum()
    assert autograd_profiler._is_profiler_enabled is False
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("name", "").startswith("test.")}
    assert {e["cat"] for e in got.values()} == {"user_annotation"}
    outer, inner = got["test.outer"], got["test.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# ------------------------------------------ the spans in the benchmark
def _traced_cell(cell: str, kind: str, seconds: float, monkeypatch):
    """Run ``cell`` traced on the CPU: (result line, its DeviceTrace)."""
    kept = {}
    plain = harness.device_trace

    @contextlib.contextmanager
    def keeping(into, on_card=True, label="port_bench.window"):
        with plain(into, on_card, label):
            yield
        kept["trace"] = into["device_trace"]

    monkeypatch.setattr(harness, "device_trace", keeping)
    result, _checks, _notes = run.run_cell(
        cell, SEED, seconds, True, compute_device="cpu",
        traffic_override=TINY[kind], scale=SCALE)
    return result, kept["trace"]


def _parents(tr: DeviceTrace) -> list[tuple[str, str | None]]:
    """(name, name of the innermost program span around it) of every
    program span of the trace."""
    spans = sorted(((a, b, n) for a, b, n in tr.host
                    if n.startswith(("des.", "store."))),
                   key=lambda s: (s[0], -s[1]))
    out, open_ = [], []
    for a, b, n in spans:
        while open_ and open_[-1][0] <= a:
            open_.pop()
        out.append((n, open_[-1][1] if open_ else None))
        open_.append((b, n))
    return out


def _parents_of(pairs) -> dict[str, set]:
    by: dict[str, set] = {}
    for n, p in pairs:
        by.setdefault(n, set()).add(p)
    return by


@pytest.mark.parametrize("cell", ["vlsm.ycsb_a.replay",
                                  "rocksdb.ycsb_a.replay"])
def test_replay_spans_nest(cell, monkeypatch):
    result, tr = _traced_cell(cell, "replay", 0.0, monkeypatch)
    assert result["correct"] is True
    by = _parents_of(_parents(tr))
    assert by["des.run"] == {None}
    for child in ("des.setup", "des.window", "des.fill", "des.inflation",
                  "des.lindley"):
        assert by[child] == {"des.run"}, child
    assert by["store.apply"] == {"des.window"}
    assert by["store.lookup"] == {"store.apply"}
    assert by["store.write"] <= {"des.window", "store.apply"}
    assert by["store.flush"] == by["store.triggers"] == {"des.fill"}
    assert by["store.chain"] <= {"store.flush", "store.triggers"}
    assert by["store.merge_runs"] <= {"store.chain", "store.merge_down"}
    assert "store.chain" in by["store.merge_runs"]     # the L0 stages
    assert by.get("store.merge_down", {"store.chain"}) == {"store.chain"}
    if cell.startswith("vlsm"):
        # merges from L1 down run inside merge_down; vSSTs are planned
        # by the L0 stage, inside its chain
        assert "store.merge_down" in by["store.merge_runs"]
        assert by["store.vsst_plan"] == {"store.chain"}
    names = {m["name"] for m in harness.benchmark()["per_layer"]
             if cell in m["workloads"]}
    assert {"des_self_pct.replay", "store_self_pct.replay",
            "chain_pct.replay"} <= set(result["metrics"]) <= names


def test_served_spans_nest(monkeypatch):
    result, tr = _traced_cell("vlsm.ycsb_a.served", "served", 0.5,
                              monkeypatch)
    assert result["correct"] is True
    by = _parents_of(_parents(tr))
    assert by["store.batch"] == {None}
    assert by["store.write"] == {"store.batch"}
    assert by["store.apply"] == {"store.batch"}
    assert by["store.lookup"] == {"store.apply"}
    assert by["store.roll"] == {"store.batch"}
    assert by["store.flush"] == by["store.triggers"] == {"store.roll"}
    assert by["store.chain"] <= {"store.flush", "store.triggers"}
    assert by["store.merge_runs"] <= {"store.chain", "store.merge_down"}
    assert {"lookup_ms.served", "roll_ms.served"} <= set(result["metrics"])


def test_replay_equal_with_profiler_on_and_off():
    _cell, spec, traffic = harness.cell_files("vlsm.ycsb_a.replay")
    entry = harness.entry_module("replay").Entry(
        spec, {**traffic, **TINY["replay"]}, SEED, compute_device="cpu",
        scale=SCALE)
    entry._replay()
    with profile(activities=[ProfilerActivity.CPU]):
        entry._replay()
    off, on = entry.runs
    assert off["ledger"]["flush"].shape[0] > 0
    for key in ("latency", "get_reads", "get_probed"):
        assert np.array_equal(off[key], on[key]), key
    for key, col in off["ledger"].items():
        assert np.array_equal(col, on["ledger"][key]), key
    assert off["merged_keys"] == on["merged_keys"]
    assert off["stalls"] == on["stalls"]


def test_served_answers_equal_with_profiler_on_and_off():
    _cell, spec, traffic = harness.cell_files("vlsm.ycsb_a.served")
    traffic = {**traffic, **TINY["served"]}
    entry_cls = harness.entry_module("served").Entry
    answers = []
    for traced in (False, True):
        entry = entry_cls(spec, traffic, SEED, compute_device="cpu",
                          scale=SCALE)
        jobs = len(entry.store.job_log)
        with profile(activities=[ProfilerActivity.CPU]) if traced \
                else contextlib.nullcontext():
            entry._serve(12)
        assert len(entry.store.job_log) > jobs       # memtables rolled
        answers.append((entry.served, entry.answers))
    (served_off, off), (served_on, on) = answers
    assert served_off == served_on
    assert all(np.array_equal(a, b) for a, b in zip(off, on))


# ----------------------------------------------------------- the readers
def _read(name: str, art: dict):
    return harness.metric_reader(name)(art)


READERS = ["des_self_pct.replay", "store_self_pct.replay",
           "chain_pct.replay", "merge_step_roofline.replay",
           "lookup_ms.served", "roll_ms.served"]


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(name):
    assert _read(name, {}) is None
    # a program that records no spans (the benchmark's parent): aten ops
    # and the benchmark's own spans only
    tr = DeviceTrace(1.0, [(0.1, 0.2, "merge_path_kernel(long const*)")],
                     [(0.0, 0.9, "port_bench.simulator_run"),
                      (0.1, 0.2, "aten::copy_")])
    art = {"device_trace": tr, "compaction_bytes": (1000.0, 1000.0),
           "kv_size": 100, "merged_keys": 10}
    assert _read(name, art) is None


def test_self_time_subtracts_nested_program_spans():
    host = [(0.0, 10.0, "des.run"),
            (1.0, 3.0, "des.window"),
            (1.5, 2.5, "store.apply"),
            (1.6, 2.0, "aten::add"),          # the span's own work
            (4.0, 8.0, "des.fill"),
            (4.5, 7.0, "store.flush"),
            (5.0, 6.0, "store.chain"),
            (11.0, 12.0, "port_bench.new_simulator")]
    art = {"device_trace": DeviceTrace(20.0, [], host)}
    # des: run 10 - 2 - 4, window 2 - 1, fill 4 - 2.5
    assert _read("des_self_pct.replay", art) == pytest.approx(
        100 * 6.5 / 20)
    # store: apply 1, flush 2.5 - 1, chain 1
    assert _read("store_self_pct.replay", art) == pytest.approx(
        100 * 3.5 / 20)


def test_chain_pct_is_the_union_of_chains():
    host = [(1.0, 3.0, "store.chain"), (2.0, 4.0, "store.chain"),
            (6.0, 7.0, "store.chain"), (6.2, 6.8, "store.chain"),
            (0.0, 9.0, "des.run")]
    art = {"device_trace": DeviceTrace(10.0, [], host)}
    assert _read("chain_pct.replay", art) == pytest.approx(40.0)


def test_merge_step_counts_intervals_by_where_they_start():
    host = [(1.0, 2.0, "store.merge_runs"), (5.0, 6.0, "store.merge_runs"),
            (0.0, 9.0, "store.chain")]
    dev = [(1.2, 1.5, "merge_path_kernel(long const*)"),   # inside
           (1.9, 2.4, "index_elementwise_kernel"),          # starts inside
           (2.5, 2.6, "merge_path_kernel(long const*)"),   # after
           (0.5, 1.1, "Memcpy HtoD"),                      # starts before
           (5.0, 5.1, "Memcpy DtoH")]                      # at the start
    kv, keys_read, keys_written = 200, 3_000, 2_000
    art = {"device_trace": DeviceTrace(10.0, dev, host), "kv_size": kv,
           "compaction_bytes": (float(kv * keys_read),
                                float(kv * keys_written)),
           "merged_keys": keys_written}
    want = roofline_pct(16 * (keys_read + keys_written), 0.3 + 0.5 + 0.1)
    assert _read("merge_step_roofline.replay", art) == pytest.approx(want)
    # keys written that the ledger and Stats disagree on: nothing read
    assert _read("merge_step_roofline.replay",
                 {**art, "merged_keys": keys_written + 1}) is None


@pytest.mark.parametrize("name,span", [("lookup_ms.served", "store.lookup"),
                                       ("roll_ms.served", "store.roll")])
def test_served_readers_take_the_median(name, span):
    host = [(0.0, 0.001, span), (0.010, 0.012, span), (0.020, 0.030, span),
            (0.0, 0.050, "store.batch"), (0.031, 0.040, "aten::copy_")]
    art = {"device_trace": DeviceTrace(0.05, [], host)}
    assert _read(name, art) == pytest.approx(2.0)
