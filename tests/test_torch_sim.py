"""The port's whole slice — ``Simulator.run`` over the store, its policies and
the final Lindley pass — against the JAX package's reference on the CPU
(``compute_device="cpu"``, the plain PyTorch tier).

The reference runs on its numpy tiers, pinned by ``tests/_torch_parity.py``
(its jnp/pallas tiers do not run on JAX 0.9.0).  Uids seed the bloom model, so both sides rewind
their uid counters before every run.  The port must equal the reference —
per-op reads/probed, every level's SSTs, Stats, the chain ledger and stalls
— and its latencies must agree within 1e-9 s, the reference's own
engine-parity tolerance (``tests/test_sim.py``).  Nothing here asserts the
paper's inequalities.
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from repro.bench_kv.workloads import (load_keys, make_run_a, make_run_b,
                                      make_run_c)
from repro.core import DeviceModel as RefDeviceModel
from repro.core import Simulator as RefSimulator
from repro.core import get_policy as ref_policy
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.core import DeviceModel, Simulator, get_policy
from repro_torch.core.uids import reset_uid_counters as port_reset
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 18
POLICIES = ["vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi", "lazy"]
REF = json.loads((Path(__file__).parent / "data" /
                  "read_parity_seed.json").read_text())
# the seed capture predates the lazy policy
CAPTURED = [p for p in POLICIES if f"{p}:run_a" in REF["cases"]]


def _ycsb_a(n_pop: int, n_run: int, rate: float):
    pop = np.unique(load_keys(n_pop, seed=7))
    spec = make_run_a(pop, n_run, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    arrivals = np.arange(ops.shape[0], dtype=np.float64) / rate
    return ops, keys, arrivals


def _run_both(pname: str, n_shards: int, trace, scale: int = SCALE,
              n_regions: int = 1):
    ops, keys, arrivals = trace
    lam = scale / (64 << 20)
    ref_reset()
    ref_cfg = ref_policy(pname).default_config(scale).with_(n_shards=n_shards)
    ref_sim = RefSimulator(ref_cfg, RefDeviceModel.scaled(lam),
                           n_regions=n_regions)
    ref_res = ref_sim.run(ops, keys, arrivals)
    port_reset()
    cfg = get_policy(pname).default_config(scale).with_(n_shards=n_shards)
    sim = Simulator(cfg, DeviceModel.scaled(lam), n_regions=n_regions,
                    compute_device="cpu")
    res = sim.run(ops, keys, arrivals)
    return ref_sim, ref_res, sim, res


def _counters(stats) -> dict:
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in ("chains", "chain_index", "tenants")}


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pname", POLICIES)
def test_simulator_matches_reference(pname, n_shards):
    trace = _ycsb_a(20_000, 12_000, 40_000.0)
    ref_sim, ref_res, sim, res = _run_both(pname, n_shards, trace)
    np.testing.assert_array_equal(res.get_reads, ref_res.get_reads)
    np.testing.assert_array_equal(res.get_probed, ref_res.get_probed)
    for ref_tree, tree in zip(ref_sim.trees, sim.trees, strict=True):
        assert tree.seq == ref_tree.seq
        for ref_lvl, lvl in zip(ref_tree.levels, tree.levels, strict=True):
            assert [s.uid for s in lvl] == [s.uid for s in ref_lvl]
            for ref_sst, sst in zip(ref_lvl, lvl):
                np.testing.assert_array_equal(sst.keys.numpy(), ref_sst.keys)
                np.testing.assert_array_equal(sst.seqs.numpy(), ref_sst.seqs)
    for ref_st, st in zip(ref_sim.shard_stats, sim.shard_stats, strict=True):
        assert _counters(st) == _counters(ref_st)
        assert [dataclasses.asdict(c) for c in st.chains] == \
            [dataclasses.asdict(c) for c in ref_st.chains]
    assert res.chain_report() == ref_res.chain_report()
    assert res.n_stalls == ref_res.n_stalls
    assert res.stall_events == ref_res.stall_events
    assert float(np.max(np.abs(res.latency - ref_res.latency))) < 1e-9
    assert res.makespan == pytest.approx(ref_res.makespan, abs=1e-9)
    assert [(j.kind, j.level, j.uid, j.chain_id, j.t_start, j.t_finish)
            for j in res.job_log] == \
        [(j.kind, j.level, j.uid, j.chain_id, j.t_start, j.t_finish)
         for j in ref_res.job_log]


def test_trace_exercises_compactions_and_stalls():
    """The parity trace is only meaningful if it drives the machinery."""
    _, _, sim, res = _run_both("vlsm", 1, _ycsb_a(20_000, 12_000, 40_000.0))
    assert res.n_stalls > 0 and len(sim.stats.chains) > 50
    assert sim.stats.vssts_good > 0 and sim.trees[0].levels[2]


_WORKLOADS = {"run_a": make_run_a, "run_b": make_run_b, "run_c": make_run_c}


@pytest.mark.parametrize("wname", list(_WORKLOADS))
@pytest.mark.parametrize("pname", CAPTURED)
def test_read_accounting_matches_seed_capture(pname, wname):
    """The per-op sha256 captures of ``tests/data/read_parity_seed.json``,
    replayed through the port (trace built as tests/test_read_parity.py
    builds it)."""
    meta = REF["meta"]
    want = REF["cases"][f"{pname}:{wname}"]
    pop = np.unique(load_keys(meta["n_pop"], seed=meta["pop_seed"]))
    spec = _WORKLOADS[wname](pop, meta["n_run"], dist=meta["dist"])
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    arrivals = np.arange(ops.shape[0], dtype=np.float64) / meta["rate"]
    port_reset()
    cfg = get_policy(pname).default_config(meta["scale"])
    sim = Simulator(cfg, DeviceModel.scaled(meta["scale"] / (64 << 20)),
                    n_regions=meta["n_regions"], compute_device="cpu")
    res = sim.run(ops, keys, arrivals)
    g = res.op_types == 1
    reads = res.get_reads[g].astype(np.int64)
    probed = res.get_probed[g].astype(np.int64)
    assert int(sim.stats.device_reads) == want["device_reads"]
    assert int(sim.stats.ops) == want["ops"]
    assert int(reads.shape[0]) == want["n_gets"]
    assert int(reads.sum()) == want["reads_sum"]
    assert int(probed.sum()) == want["probed_sum"]
    assert hashlib.sha256(reads.tobytes()).hexdigest() == want["reads_sha256"]
    assert (hashlib.sha256(probed.tobytes()).hexdigest()
            == want["probed_sha256"])


def test_regions_and_range_router_match():
    """The two other routing shapes of the DES: regions behind one queue,
    and range-partitioned shards."""
    trace = _ycsb_a(8_000, 6_000, 30_000.0)
    _, ref_res, _, res = _run_both("vlsm", 1, trace, n_regions=2)
    np.testing.assert_array_equal(res.get_reads, ref_res.get_reads)
    assert float(np.max(np.abs(res.latency - ref_res.latency))) < 1e-9
    ops, keys, arrivals = trace
    ref_reset()
    ref_cfg = ref_policy("rocksdb").default_config(SCALE).with_(
        n_shards=3, shard_router="range")
    ref_res = RefSimulator(ref_cfg, RefDeviceModel.scaled(1 / 256)).run(
        ops, keys, arrivals)
    port_reset()
    cfg = get_policy("rocksdb").default_config(SCALE).with_(
        n_shards=3, shard_router="range")
    res = Simulator(cfg, DeviceModel.scaled(1 / 256),
                    compute_device="cpu").run(ops, keys, arrivals)
    np.testing.assert_array_equal(res.shard_ids, ref_res.shard_ids)
    np.testing.assert_array_equal(res.get_probed, ref_res.get_probed)
    assert float(np.max(np.abs(res.latency - ref_res.latency))) < 1e-9
