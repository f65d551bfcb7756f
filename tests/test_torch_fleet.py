"""The port's fleet engine, sweeps and list-of-queues Lindley front end
against the JAX package's reference on the CPU (``compute_device="cpu"``).

The reference's ``FleetEngine.run`` defaults to its jnp tier, which does
not run on JAX 0.9.0, so every reference call here passes
``backend="numpy"``; its merge and index tiers are pinned to numpy by
``tests/_torch_parity.py``.  Both sides rewind their uid counters before
every run.  Latencies must agree within 1e-9 s, stall events and chain
snapshots exactly.
"""

import numpy as np
import pytest

from repro.bench_kv.workloads import load_keys, make_run_a
from repro.core import DeviceModel as RefDeviceModel
from repro.core import fleet as ref_fleet
from repro.core import policies as ref_policies
from repro.kernels.lindley_scan.ops import lindley_batch_np as ref_lindley
from repro_torch.core import (DeviceModel, FleetEngine, StructuralCache,
                              SweepPoint, fleet_sweep, point_key, policies,
                              run_point, serial_sweep, sweep_execute,
                              traffic_curve)
from repro_torch.core.uids import reset_uid_counters as port_reset
from repro_torch.kernels.lindley_scan.ops import lindley_batch_np
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 16
LAM = SCALE / (64 << 20)


def _stream(n_pop: int = 6_000, n_run: int = 4_000):
    pop = np.unique(load_keys(n_pop, seed=7))
    spec = make_run_a(pop, n_run, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    return ops, np.concatenate([pop, spec.keys]), pop.shape[0]


def _arrivals(n_load: int, n_run: int, rate: float) -> np.ndarray:
    load = np.arange(n_load, dtype=np.float64) / 1e6
    return np.concatenate(
        [load, load[-1] + 0.5 + np.arange(n_run, dtype=np.float64) / rate])


def _same(res, ref) -> None:
    assert res.stall_events == ref.stall_events
    assert res.chain_counts == ref.chain_counts
    assert res.chain_stall_s == pytest.approx(ref.chain_stall_s, abs=1e-9)
    np.testing.assert_array_equal(res.get_reads, ref.get_reads)
    assert float(np.max(np.abs(res.latency - ref.latency))) < 1e-9


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pname", ["vlsm", "rocksdb", "rocksdb_io", "adoc",
                                   "lsmi", "lazy"])
def test_fleet_engine_run_matches_reference(pname, n_shards):
    ops, keys, n_load = _stream()
    arrivals = _arrivals(n_load, ops.shape[0] - n_load, 20_000.0)
    ref_fleet.reset_uid_counters()
    ref_cfg = ref_policies.get(pname).default_config(SCALE).with_(
        n_shards=n_shards)
    ref = ref_fleet.FleetEngine(ref_cfg, RefDeviceModel.scaled(LAM)).run(
        ops, keys, arrivals, backend="numpy")
    port_reset()
    cfg = policies.get(pname).default_config(SCALE).with_(n_shards=n_shards)
    res = FleetEngine(cfg, DeviceModel.scaled(LAM),
                      compute_device="cpu").run(ops, keys, arrivals)
    _same(res, ref)
    assert res.makespan == pytest.approx(ref.makespan, abs=1e-9)


def _points(names, shard_counts, rates, n_pop=4_000, n_run=3_000):
    ops, keys, n_load = _stream(n_pop, n_run)
    grid = [_arrivals(n_load, ops.shape[0] - n_load, r) for r in rates]
    port = [SweepPoint(f"{nm}/{k}", policies.get(nm).default_config(SCALE)
                       .with_(n_shards=k), DeviceModel.scaled(LAM), ops,
                       keys, arrivals_grid=grid)
            for nm in names for k in shard_counts]
    ref = [ref_fleet.SweepPoint(p.label, ref_policies.get(nm)
                                .default_config(SCALE).with_(n_shards=k),
                                RefDeviceModel.scaled(LAM), ops, keys,
                                arrivals_grid=grid)
           for p, (nm, k) in zip(port, [(nm, k) for nm in names
                                        for k in shard_counts])]
    return port, ref


def test_fleet_sweep_matches_serial_sweep_and_reference():
    port, ref = _points(["vlsm", "adoc", "lazy"], (1, 4),
                        (5_000.0, 20_000.0, 60_000.0))
    got = fleet_sweep(port, compute_device="cpu")
    oracle = serial_sweep(port, compute_device="cpu")
    want = ref_fleet.fleet_sweep(ref, backend="numpy")
    assert [len(r) for r in got] == [3] * len(port)
    stalled = 0
    for g_pt, o_pt, w_pt in zip(got, oracle, want, strict=True):
        for g, o, w in zip(g_pt, o_pt, w_pt, strict=True):
            _same(g, w)
            assert g.stall_events == o.stall_events
            assert float(np.max(np.abs(g.latency - o.latency))) < 1e-9
            stalled += g.n_stalls > 0
    assert stalled, "the sweep should reach a stalling rate"


def test_traffic_curve_matches_reference():
    ops, keys, n_load = _stream()
    grid = [_arrivals(n_load, ops.shape[0] - n_load, r)
            for r in (4_000.0, 30_000.0)]
    ref_fleet.reset_uid_counters()
    ref_eng = ref_fleet.FleetEngine(
        ref_policies.get("lsmi").default_config(SCALE).with_(n_shards=2),
        RefDeviceModel.scaled(LAM))
    want = ref_fleet.traffic_curve(ref_eng, ops, keys, None, grid,
                                   backend="numpy")
    port_reset()
    eng = FleetEngine(policies.get("lsmi").default_config(SCALE).with_(
        n_shards=2), DeviceModel.scaled(LAM), compute_device="cpu")
    got = traffic_curve(eng, ops, keys, None, grid)
    for g, w in zip(got, want, strict=True):
        _same(g, w)


@pytest.mark.parametrize("with_d0", [False, True])
def test_lindley_front_end_matches_reference(with_d0):
    rng = np.random.default_rng(3)
    lens = [0, 1, 5, 0, 4_096, 4_097, 300, 0]
    services = [rng.exponential(1e-3, n) for n in lens]
    arrivals = [np.sort(rng.uniform(0, 5, n)) for n in lens]
    d0 = list(rng.uniform(-1, 6, len(lens))) if with_d0 else None
    got = lindley_batch_np(services, arrivals, d0, compute_device="cpu")
    want = ref_lindley(services, arrivals, d0, backend="numpy")
    assert [g.shape for g in got] == [(n,) for n in lens]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)     # bit for bit


def test_lindley_front_end_empty_batches():
    assert lindley_batch_np([], [], compute_device="cpu") == []
    out = lindley_batch_np([np.empty(0)] * 3, [np.empty(0)] * 3,
                           compute_device="cpu")
    assert [o.shape for o in out] == [(0,)] * 3
    with pytest.raises(ValueError):
        lindley_batch_np([np.ones(2)], [], compute_device="cpu")


def test_point_key_covers_structure_not_arrivals():
    port, _ = _points(["vlsm", "rocksdb"], (1,), (5_000.0,))
    a, b = port
    assert point_key(a) == point_key(SweepPoint(
        "other label", a.cfg, a.device, a.op_types.copy(), a.keys.copy(),
        arrivals=a.grid[0] * 2))
    assert point_key(a) != point_key(b)
    assert point_key(a) != point_key(SweepPoint(
        a.label, a.cfg.with_(n_shards=2), a.device, a.op_types, a.keys,
        arrivals_grid=a.grid))
    keys = a.keys.copy()
    keys[-1] += 1
    assert point_key(a) != point_key(SweepPoint(
        a.label, a.cfg, a.device, a.op_types, keys, arrivals_grid=a.grid))


def test_structural_cache_hits_evicts_and_replays_bit_identically():
    port, _ = _points(["vlsm", "rocksdb", "lsmi"], (1,), (5_000.0, 40_000.0))
    cache = StructuralCache(maxsize=2)
    first, t0 = run_point(port[0], compute_device="cpu", cache=cache)
    again, t1 = run_point(port[0], compute_device="cpu", cache=cache)
    assert (t0.cache_hit, t1.cache_hit) == (False, True)
    assert t1.structural_s == 0.0 and t1.row(0)["cache_hit"]
    for a, b in zip(first, again, strict=True):
        np.testing.assert_array_equal(a.latency.view(np.int64),
                                      b.latency.view(np.int64))
        assert a.stall_events == b.stall_events
    run_point(port[1], compute_device="cpu", cache=cache)
    run_point(port[2], compute_device="cpu", cache=cache)
    assert point_key(port[0]) not in cache and len(cache) == 2
    assert cache.stats() == {"size": 2, "maxsize": 2, "hits": 1,
                             "misses": 3}
    cache.clear()
    assert len(cache) == 0 and cache.hits == 0


def test_sweep_execute_spawned_workers_give_identical_results():
    port, _ = _points(["vlsm", "adoc", "lazy"], (1, 4), (5_000.0, 60_000.0),
                      n_pop=3_000, n_run=2_000)
    one, t_one = sweep_execute(port, workers=1, compute_device="cpu")
    two, t_two = sweep_execute(port, workers=2, compute_device="cpu")
    assert [t.label for t in t_one] == [t.label for t in t_two]
    oracle = fleet_sweep(port, compute_device="cpu")
    for p1, p2, po in zip(one, two, oracle, strict=True):
        for a, b, o in zip(p1, p2, po, strict=True):
            np.testing.assert_array_equal(a.latency.view(np.int64),
                                          b.latency.view(np.int64))
            np.testing.assert_array_equal(a.latency.view(np.int64),
                                          o.latency.view(np.int64))
            assert a.stall_events == b.stall_events == o.stall_events
            assert a.chain_counts == b.chain_counts


def test_fleet_entry_points_default_to_cuda():
    port, _ = _points(["vlsm"], (1,), (5_000.0,), n_pop=500, n_run=200)
    cfg = port[0].cfg
    import torch
    if torch.cuda.is_available():
        assert FleetEngine(cfg).compute_device.type == "cuda"
        return
    for call in (lambda: FleetEngine(cfg), lambda: fleet_sweep(port),
                 lambda: serial_sweep(port), lambda: sweep_execute(port),
                 lambda: run_point(port[0]),
                 lambda: lindley_batch_np([np.ones(3)], [np.ones(3)])):
        with pytest.raises(RuntimeError, match="compute_device='cpu'"):
            call()
