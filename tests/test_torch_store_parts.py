"""The port's store building blocks against the reference on the CPU: the
policy registry and canned configs, SST and memtable point lookups, and the
list-level fence oracles."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.memtable as ref_memtable
import repro.core.sst as ref_sst
import repro.core.vsst as ref_vsst
from repro.core import get_policy as ref_policy
from repro_torch.core import get_policy, policies
from repro_torch.core import memtable as port_memtable
from repro_torch.core import sst as port_sst
from repro_torch.core import vsst as port_vsst

CPU = torch.device("cpu")


def test_registry_resolves_the_ported_policies():
    assert policies.names() == ["vlsm", "rocksdb", "rocksdb_io", "adoc",
                                "lsmi", "lazy"]
    with pytest.raises(KeyError, match="registered policies"):
        get_policy("no_such_policy")
    with pytest.raises(ValueError, match="already registered"):
        policies.register(get_policy("vlsm"))


@pytest.mark.parametrize("pname", ["vlsm", "rocksdb", "rocksdb_io", "adoc",
                                   "lsmi", "lazy"])
@pytest.mark.parametrize("scale", [1 << 17, 64 << 20])
def test_canned_configs_match_reference(pname, scale):
    ref_cfg = dataclasses.asdict(ref_policy(pname).default_config(scale))
    cfg = dataclasses.asdict(get_policy(pname).default_config(scale))
    ref_cfg.pop("index_backend")      # the reference's jnp/pallas switch
    assert cfg == ref_cfg
    ref_pol, pol = ref_policy(pname), get_policy(pname)
    c_ref = ref_pol.default_config(scale)
    c = pol.default_config(scale)
    for level in range(c.max_levels):
        assert pol.level_target(c, level) == ref_pol.level_target(c_ref, level)
        assert pol.level_limit(c, level) == ref_pol.level_limit(c_ref, level)


def _ssts(seed: int):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 5_000, 900)).astype(np.int64)
    parts = np.array_split(keys, 12)
    ref = [ref_sst.SST(p, p * 3, 200) for p in parts]
    port = [port_sst.SST(torch.from_numpy(p), torch.from_numpy(p * 3), 200)
            for p in parts]
    return rng, keys, ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_sst_lookups_and_level_oracles(seed):
    rng, keys, ref, port = _ssts(seed)
    probes = np.concatenate([keys[::37], rng.integers(-10, 5_010, 60)])
    for r, p in zip(ref, port):
        assert (p.smallest, p.largest, p.size) == \
            (r.smallest, r.largest, r.size)
        for k in probes[:40]:
            assert p.get(int(k)) == r.get(int(k))
            got_k, got_s = p.scan_from(int(k), 7)
            want_k, want_s = r.scan_from(int(k), 7)
            np.testing.assert_array_equal(got_k.numpy(), want_k)
            np.testing.assert_array_equal(got_s.numpy(), want_s)
    for lo in probes:
        hi = int(lo) + int(rng.integers(0, 800))
        assert [s.smallest for s in port_sst.overlapping(port, int(lo), hi)] \
            == [s.smallest for s in ref_sst.overlapping(ref, int(lo), hi)]
    lo_p, hi_p = port_vsst.l2_fences(port, CPU)
    lo_r, hi_r = ref_vsst.l2_fences(ref)
    np.testing.assert_array_equal(lo_p.numpy(), lo_r)
    np.testing.assert_array_equal(hi_p.numpy(), hi_r)
    assert port_vsst.overlap_count_range(lo_p, hi_p, 100, 2_000) == \
        ref_vsst.overlap_count_range(lo_r, hi_r, 100, 2_000)


def test_memtable_matches_reference():
    rng = np.random.default_rng(4)
    ref = ref_memtable.Memtable(1 << 16, 200)
    port = port_memtable.Memtable(1 << 16, 200, CPU)
    seq = 0
    for _ in range(5):
        k = rng.integers(0, 300, 50).astype(np.int64)
        s = np.arange(seq, seq + 50, dtype=np.int64)
        seq += 50
        ref.put_batch(k, s)
        port.put_batch(torch.from_numpy(k), torch.from_numpy(s))
    assert (port.n, port.room, port.full) == (ref.n, ref.room, ref.full)
    for key in range(-2, 305, 7):
        assert port.get(key) == ref.get(key)
    probes = np.arange(-5, 310, dtype=np.int64)
    np.testing.assert_array_equal(
        port.get_batch(torch.from_numpy(probes)).numpy(),
        ref.get_batch(probes))
    got_k, got_s, more = port.scan_from(120, 16)
    want_k, want_s, want_more = ref.scan_from(120, 16)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert more == want_more
    sst = port.to_sst()
    np.testing.assert_array_equal(sst.keys.numpy(), ref.to_sorted()[0])
