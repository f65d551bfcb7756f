"""The port's ``adoc``, ``lsmi`` and ``lazy`` policies and the registry
surface they come with, against the JAX package's reference on the CPU
(``compute_device="cpu"``, the plain PyTorch tier).

Each policy replays a write-heavy trace (a load flood, then YCSB-A fast
enough to stall) on both sides, at 1 and 4 shards: every level's SSTs, the
Stats counters, the chain ledger, the job log and the stalls must be equal,
per-op reads/probed identical, latencies within 1e-9 s.  The reference runs
on its numpy tiers (``tests/_torch_parity.py``); both sides rewind their
uid counters first, because uids seed the bloom model.
"""

import dataclasses

import numpy as np
import pytest

from repro.bench_kv.workloads import load_keys, make_run_a
from repro.core import DeviceModel as RefDeviceModel
from repro.core import LSMConfig as RefLSMConfig
from repro.core import Simulator as RefSimulator
from repro.core import policies as ref_policies
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.core import (DeviceModel, LSMConfig, Policy, Simulator,
                              policies)
from repro_torch.core.uids import reset_uid_counters as port_reset
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 16
NEW = ["adoc", "lsmi", "lazy"]


def _trace(n_pop: int = 12_000, n_run: int = 6_000, rate: float = 20_000.0):
    pop = np.unique(load_keys(n_pop, seed=7))
    spec = make_run_a(pop, n_run, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    load = np.arange(pop.shape[0], dtype=np.float64) / 1e6
    run = load[-1] + 0.5 + np.arange(n_run, dtype=np.float64) / rate
    return ops, keys, np.concatenate([load, run])


def _counters(stats) -> dict:
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in ("chains", "chain_index", "tenants")}


def _replay(pname: str, n_shards: int):
    ops, keys, arrivals = _trace()
    lam = SCALE / (64 << 20)
    ref_reset()
    ref_cfg = ref_policies.get(pname).default_config(SCALE).with_(
        n_shards=n_shards)
    ref_sim = RefSimulator(ref_cfg, RefDeviceModel.scaled(lam))
    ref_res = ref_sim.run(ops, keys, arrivals)
    port_reset()
    cfg = policies.get(pname).default_config(SCALE).with_(n_shards=n_shards)
    sim = Simulator(cfg, DeviceModel.scaled(lam), compute_device="cpu")
    return ref_sim, ref_res, sim, sim.run(ops, keys, arrivals)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pname", NEW)
def test_policy_replay_matches_reference(pname, n_shards):
    ref_sim, ref_res, sim, res = _replay(pname, n_shards)
    np.testing.assert_array_equal(res.get_reads, ref_res.get_reads)
    np.testing.assert_array_equal(res.get_probed, ref_res.get_probed)
    for ref_tree, tree in zip(ref_sim.trees, sim.trees, strict=True):
        assert tree.level_sizes() == ref_tree.level_sizes()
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
    assert res.stall_events == ref_res.stall_events
    assert [(j.kind, j.level, j.uid, j.chain_id, j.n_in_ssts, j.t_start,
             j.t_finish) for j in res.job_log] == \
        [(j.kind, j.level, j.uid, j.chain_id, j.n_in_ssts, j.t_start,
          j.t_finish) for j in ref_res.job_log]
    assert float(np.max(np.abs(res.latency - ref_res.latency))) < 1e-9


def test_replay_trace_exercises_each_policy():
    """The replay trace is only meaningful if it reaches what each policy
    changes: stalls, ADOC's batched background chains, LSMi's narrow
    chains over several levels, lazy's wholesale intermediate moves."""
    _, _, sim, res = _replay("adoc", 1)
    assert res.n_stalls > 0 and sim.stats.chain_report()[
        "n_background_chains"] > 0
    _, _, sim, _ = _replay("lsmi", 1)
    assert sim.stats.chain_report()["max_width_ssts"] == 1
    assert sum(1 for s in sim.trees[0].level_sizes()[1:] if s) >= 2
    _, _, sim, res = _replay("lazy", 1)
    cfg = sim.cfg
    mid = [j for j in res.job_log if j.kind == "compact"
           and 1 <= j.level < cfg.max_levels - 2]
    assert mid and max(j.n_in_ssts for j in mid) > 1


def test_lsmi_sorted_load_merges_nothing_as_the_reference():
    """The smoke run's store trace in small (sorted unique load at 500,000
    ops/s, a 10 s settle, YCSB A at 8,000 ops/s): LSMi moves each L0 SST
    into an empty key range and merges nothing, on both sides, with the
    same job log; so its merge_path count of 0 on the card is the
    reference's and not an input count gone missing."""
    pop = np.unique(load_keys(8_000, seed=7))
    spec = make_run_a(pop, 2_000, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    load = np.arange(pop.shape[0], dtype=np.float64) / 500_000.0
    arrivals = np.concatenate(
        [load, load[-1] + 10.0 + np.arange(2_000, dtype=np.float64) / 8e3])
    lam = SCALE / (64 << 20)
    ref_reset()
    ref_res = RefSimulator(ref_policies.get("lsmi").default_config(SCALE),
                           RefDeviceModel.scaled(lam)).run(ops, keys,
                                                           arrivals)
    port_reset()
    res = Simulator(policies.get("lsmi").default_config(SCALE),
                    DeviceModel.scaled(lam), compute_device="cpu").run(
                        ops, keys, arrivals)

    def jobs(r):
        return [(j.kind, j.level, j.n_in_ssts, j.n_out_ssts, j.bytes_read,
                 j.bytes_written) for j in r.job_log]
    assert jobs(res) == jobs(ref_res)
    compactions = [j for j in ref_res.job_log if j.kind == "compact"]
    assert compactions and all(j.n_in_ssts == 1 for j in compactions)


def test_registry_lists_the_six_policies_in_canonical_order():
    assert policies.names() == ["vlsm", "rocksdb", "rocksdb_io", "adoc",
                                "lsmi", "lazy"]
    assert policies.names() == ref_policies.names()


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "index_backend"}


@pytest.mark.parametrize("scale", [1 << 16, 1 << 20])
def test_default_configs_match_reference(scale):
    got = policies.default_configs(scale)
    want = ref_policies.default_configs(scale)
    assert list(got) == list(want)
    for name in want:
        assert _fields(got[name]) == _fields(want[name])
    assert _fields(LSMConfig.adoc_default(scale)) == \
        _fields(RefLSMConfig.adoc_default(scale))
    assert _fields(LSMConfig.lsmi_default(scale)) == \
        _fields(RefLSMConfig.lsmi_default(scale))


def test_resolve_names_and_get_by_policy_member():
    assert policies.resolve_names("all") == policies.names()
    assert policies.resolve_names(" adoc, lazy ,lsmi") == \
        ["adoc", "lazy", "lsmi"]
    with pytest.raises(KeyError, match="registered policies"):
        policies.resolve_names("adoc,nope")
    for member in Policy:
        assert policies.get(member) is policies.get(member.value)
        assert LSMConfig(policy=member).policy == member.value
        assert member == member.value
    assert [m.value for m in Policy] == \
        ["vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi"]
    assert policies.get(Policy.ADOC).pick_batch(
        LSMConfig.adoc_default()) == 4
