"""The entries end to end on the CPU at tiny sizes: the result line's
keys, the reference's agreement with the port, the control, and the
faults each cell can have, each of which must turn ``correct`` false."""

import json

import numpy as np
import pytest
import torch

from port_bench import harness, limits, run
from port_bench.faults import ENTRIES, FAULTS

CELLS = {"vlsm.ycsb_a.replay": "replay", "rocksdb.ycsb_a.replay": "replay",
         "vlsm.ycsb_a.served": "served", "vlsm.ycsb_b.served": "served"}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


# the storage model matched to the tiny byte scale (``DeviceModel.scaled``
# of 1/64): the tiny replays then stall at fills and queue compactions
LAM = 1 / 64
SLOW = {"device_scale": LAM,
        "device_model": {"write_bw": 2.0e9 * LAM, "read_bw": 3.5e9 * LAM,
                         "io_latency": 1e-4, "block_size": 4096,
                         "compaction_slots": 4}}


def _run(cell, tiny, trace=False, seed=2 ** 31 + 5, slow=False):
    sizes, scale = tiny
    return run.run_cell(cell, seed, 0.0, trace, compute_device="cpu",
                        traffic_override=sizes[CELLS[cell]], scale=scale,
                        spec_override=SLOW if slow else None)


@pytest.mark.parametrize("cell", list(CELLS))
def test_result_line_and_agreement(cell, tiny):
    result, checks, _notes = _run(cell, tiny)
    assert list(result) == KEYS
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert all(v <= lim for _n, v, lim in checks)


@pytest.mark.parametrize("cell", ["vlsm.ycsb_a.replay",
                                  "rocksdb.ycsb_a.replay"])
def test_replay_agrees_where_fills_stall(cell, tiny):
    """With a slow storage model the tiny replays stall and queue their
    compactions, and the reference still agrees to the last digit."""
    result, checks, _notes = _run(cell, tiny, slow=True)
    assert result["correct"] is True
    assert {n: v for n, v, _l in checks}["latency_gap_s"] < 1e-9


@pytest.mark.parametrize("cell", ["vlsm.ycsb_a.replay", "vlsm.ycsb_a.served"])
def test_traced_result_line(cell, tiny):
    result, _checks, _notes = _run(cell, tiny, trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    names = {m["name"] for m in harness.benchmark()["per_layer"]
             if cell in m["workloads"]}
    assert set(result["metrics"]) <= names
    assert result["metrics"]


@pytest.mark.parametrize("cell", ["vlsm.ycsb_a.replay", "vlsm.ycsb_a.served"])
def test_control_fails(cell, tiny):
    sizes, scale = tiny
    (out,) = limits.readings(cell, [2 ** 31 + 9], 0.0, 1,
                             compute_device="cpu",
                             traffic_override=sizes[CELLS[cell]], scale=scale)
    assert all(v <= out["limits"][n] for n, v in out["program"].items())
    assert any(v > out["limits"][n] for n, v in out["control"].items())


# ----------------------------------------------------------- the faults
@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ["vlsm.ycsb_a.replay", "rocksdb.ycsb_a.replay",
                               "vlsm.ycsb_a.served"]
    for fault in FAULTS if CELLS[cell] in ENTRIES[fault]])
def test_fault_turns_correct_false(cell, fault, tiny):
    with FAULTS[fault]():
        result, _checks, _notes = _run(cell, tiny,
                                       slow=CELLS[cell] == "replay")
    assert result["correct"] is False
    assert result["failed"] > 0


def test_cli_without_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "vlsm.ycsb_a.replay", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_cell_on_card(card):
    result, _checks, _notes = run.run_cell("vlsm.ycsb_b.served", 2 ** 31 + 3,
                                           1.0, False)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["store_ops_per_s"]["value"])


def test_pin_cpus_keeps_two_of_the_allowed():
    """In a process of its own: the run keeps every thread on the second
    and third CPUs it may use."""
    import os
    import subprocess
    import sys
    allowed = sorted(os.sched_getaffinity(0))
    code = ("import json, os, threading, time; "
            "from port_bench.run import pin_cpus; "
            "t = threading.Thread(target=time.sleep, args=(2,)); t.start(); "
            "got = pin_cpus(); "
            "tids = os.listdir('/proc/self/task'); "
            "print(json.dumps([got, [sorted(os.sched_getaffinity(int(x))) "
            "for x in tids]])); t.join()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT).stdout
    got, per_thread = json.loads(out)
    want = allowed[1:3] if len(allowed) >= 3 else allowed
    assert got == want
    assert len(per_thread) >= 2 and all(t == want for t in per_thread)
