"""Port of the LevelIndex manifest against the reference on the CPU: the
bloom false-positive model bit for bit, and every batched fence query on
random levels."""

import itertools

import numpy as np
import pytest
import torch

import repro.core.level_index as ref_li
from repro.core.sst import SST as RefSST
from repro_torch.core import level_index as port_li
from repro_torch.core.sst import SST as PortSST
from repro_torch.kernels.overlap_scan.ops import bloom_false_positives
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

KV = 200


def _keys_and_uids(seed: int):
    rng = np.random.default_rng(seed)
    keys = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4000),
        rng.integers(0, 1 << 48, 4000), [0, -1, 2 ** 63 - 1, -2 ** 63],
    ]).astype(np.int64)
    # slot-based uids (slot << 40, slot up to 2^23) reach far beyond 2^52
    uids = np.concatenate([
        rng.integers(0, 1 << 20, keys.shape[0] // 2),
        rng.integers(1 << 52, 1 << 62, keys.shape[0] - keys.shape[0] // 2),
    ]).astype(np.int64)
    return keys, uids


@pytest.mark.parametrize("seed,fpr", [(0, 0.01), (1, 0.3), (2, 0.97)])
def test_bloom_mask_bit_for_bit(seed, fpr):
    keys, uids = _keys_and_uids(seed)
    ref_seeds = uids.astype(np.uint64) * ref_li._UID_MIX
    want = ref_li.bloom_false_positives(keys, ref_seeds, fpr)
    port_seeds = torch.from_numpy(uids) * port_li._UID_MIX
    got = bloom_false_positives(torch.from_numpy(keys), port_seeds, fpr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_seeds.numpy().view(np.uint64),
                                  ref_seeds)
    for uid in uids[::997]:     # the scalar seed of one SST, many keys
        want1 = ref_li.bloom_false_positives(
            keys, ref_li.bloom_seed_for_uid(uid), fpr)
        got1 = bloom_false_positives(
            torch.from_numpy(keys), port_li.bloom_seed_for_uid(uid), fpr)
        np.testing.assert_array_equal(got1.numpy(), want1)


def _level(rng, n_ssts: int, lo: int, hi: int, uid_base: int):
    keys = np.unique(rng.integers(lo, hi, n_ssts * 30)).astype(np.int64)
    cuts = np.array_split(keys, n_ssts)
    ref, port = [], []
    for i, c in enumerate(cuts):
        uid = uid_base + i
        r = RefSST(c, np.arange(c.shape[0], dtype=np.int64), KV)
        r.uid = uid
        ref.append(r)
        t = torch.from_numpy(c)
        port.append(PortSST(t, torch.arange(c.shape[0]), KV, uid=uid))
    return ref, port


def _indices(seed: int):
    rng = np.random.default_rng(seed)
    ref = ref_li.LevelIndex(3)
    port = port_li.LevelIndex(3, torch.device("cpu"))
    levels_ref, levels_port = [], []
    for level, (n, lo, hi) in enumerate([(5, 0, 10 ** 6), (12, 0, 10 ** 6),
                                         (40, -10 ** 5, 2 * 10 ** 6)]):
        r, p = _level(rng, n, lo, hi, 100 * level)
        if level == 0:   # L0 may overlap: shuffle append order
            order = rng.permutation(n)
            r, p = [r[i] for i in order], [p[i] for i in order]
        ref.refresh(level, r)
        port.refresh(level, p)
        levels_ref.append(r)
        levels_port.append(p)
    return rng, ref, port, levels_ref, levels_port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_queries_match(seed):
    rng, ref, port, _, levels_port = _indices(seed)
    port.check_against(levels_port)
    for level in (1, 2):
        lo = rng.integers(-2 * 10 ** 5, 2 * 10 ** 6, 500)
        hi = lo + rng.integers(0, 10 ** 5, 500)
        s_ref, e_ref = ref.overlap_ranges(level, lo, hi)
        s_port, e_port = port.overlap_ranges(level, lo, hi)
        np.testing.assert_array_equal(s_port.numpy(), s_ref)
        np.testing.assert_array_equal(e_port.numpy(), e_ref)
        np.testing.assert_array_equal(port.overlap_counts(level, lo, hi),
                                      ref.overlap_counts(level, lo, hi))
        for a, b in zip(lo[:20], hi[:20]):
            assert port.overlap_slice(level, int(a), int(b)) == \
                ref.overlap_slice(level, int(a), int(b))
        nbytes = rng.integers(0, 200 * KV * 30, 500)
        for got, want in zip(port.scan_spans(level, lo, nbytes),
                             ref.scan_spans(level, lo, nbytes)):
            np.testing.assert_array_equal(got, want)
    for src, dst in itertools.product((0, 1), (1, 2)):
        if dst > src:
            np.testing.assert_array_equal(port.overlap_bytes(src, dst),
                                          ref.overlap_bytes(src, dst))
    np.testing.assert_array_equal(port.bloom[2].numpy().view(np.uint64),
                                  ref.bloom[2])


def test_incremental_updates_match():
    rng, ref, port, levels_ref, levels_port = _indices(7)
    ref.l0_popleft()
    port.l0_popleft()
    ref.splice(1, 2, 5, levels_ref[2][:3])
    port.splice(1, 2, 5, levels_port[2][:3])
    ref.remove_uids(2, [200, 203, 239])
    port.remove_uids(2, [200, 203, 239])
    for level in range(3):
        for name in ("smallest", "largest", "sizes", "uids"):
            np.testing.assert_array_equal(getattr(port, name)[level],
                                          getattr(ref, name)[level])
        np.testing.assert_array_equal(port.dev_smallest[level].numpy(),
                                      ref.smallest[level])
        assert port.version[level] == ref.version[level]
    lo = rng.integers(0, 10 ** 6, 200)
    np.testing.assert_array_equal(port.overlap_counts(2, lo, lo + 5000),
                                  ref.overlap_counts(2, lo, lo + 5000))
