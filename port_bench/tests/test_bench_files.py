"""Every file the benchmark finds by name is there and parses, and
``BENCHMARK.json`` keeps to the shape its check reads."""

import json
import re

import pytest

from port_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "-m", "port_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_cells_in_order():
    assert [w["name"] for w in BENCH["workloads"]] == [
        "vlsm.ycsb_a.replay", "rocksdb.ycsb_a.replay",
        "vlsm.ycsb_a.served", "vlsm.ycsb_b.served"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    _cell, spec, traffic = harness.cell_files(cell)
    assert spec["name"] == _cell["config"]
    assert traffic["entry"] in ("replay", "served")
    assert harness.entry_module(traffic["entry"]).Entry.name == \
        traffic["entry"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    spec = harness.load_json(harness.ROOT / cfg["file"])
    assert spec["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert set(spec["lsm"]) == set(harness.LSM_FIELDS)
    assert set(spec["device_model"]) == set(harness.DEVICE_FIELDS)
    assert set(cfg["reduced"]) == set(spec["reduced"]) <= set(spec)
    harness.program_path()
    cfg_run = harness.lsm_config(spec)      # holds every stated number
    assert cfg_run.policy == spec["policy"]
    harness.device_model(spec)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_found_and_silent_without_data(metric):
    read = harness.metric_reader(metric["name"])
    assert read({}) is None
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_units_and_metrics():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]


def test_traffic_files_parse():
    for path in (harness.HERE / "traffic").glob("*.json"):
        json.loads(path.read_text())
