"""The GET path's fused probe (``lookup_probe`` in
``kernels/overlap_scan/ops.py``) and the runs a tree hands it.

On the CPU: the run table the host packs for the kernel matches the tree it
was built from, and the plain chain (the CPU path and the kernel's oracle)
equals a key-by-key walk of the tree written out in Python and, on the
shapes that writes alone build, the reference's own tree fed the same
writes.  On the card
(marked ``cuda``, skipped without one): the kernel equals the plain chain
on the same runs, element for element, and launches once per GET batch.

Trees are built from seeded traffic under vlsm and rocksdb, then shaped:
tombstones that shadow older values, 0 to 2 immutable memtables, L0 filled
to the policy's stop count, empty middle levels, and keys at INT64_MIN and
INT64_MAX.  The bloom FPR is raised to 0.25 so that false positives are
common enough to count.
"""

import numpy as np
import pytest
import torch

from repro.core import LSMTree as RefTree
from repro.core import get_policy as ref_policy
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.core import LSMTree, get_policy
from repro_torch.core.level_index import bloom_seed_for_uid
from repro_torch.core.types import RequestBatch
from repro_torch.core.uids import reset_uid_counters as port_reset
from repro_torch.kernels.overlap_scan import ops
from _torch_parity import reference_numpy_tiers  # noqa: F401

LO, HI = np.iinfo(np.int64).min, np.iinfo(np.int64).max
SCALE = 1 << 17
FPR = 0.25
# (immutable memtables, L0 SSTs: None as the traffic left it, "stop" at the
# policy's stop count; empty middle levels)
SHAPES = {"plain": (0, None, False), "one_immutable": (1, None, False),
          "two_immutables": (2, "stop", False), "l0_stop": (0, "stop", False),
          "gap": (1, None, True), "gap_l0_stop": (2, "stop", True)}
# the shapes that writes, seals and flushes alone build (no level moved by
# hand), which the reference's tree can be given too
WRITTEN = ("plain", "one_immutable", "l0_stop")
POLICIES = ["vlsm", "rocksdb"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused probe is a CUDA kernel")
    return torch.device("cuda")


def _fill(tree, keys, tombs):
    """Write ``keys`` through the active memtable, sealing, flushing and
    compacting whenever it fills, as the store does."""
    i = 0
    while i < keys.shape[0]:
        take = min(tree.memtable.room, keys.shape[0] - i)
        tree._write_batch(keys[i:i + take], tombs[i:i + take])
        i += take
        if tree.memtable.room == 0:
            tree.seal_memtable()
            tree.flush_immutable()
            tree.background_triggers()
            tree.drain_jobs()


def _seal_memtable_of(tree, keys, tombs):
    """A full memtable of ``keys`` sealed without a flush."""
    room = tree.memtable.room
    tree._write_batch(keys[:room], tombs[:room])
    tree.seal_memtable()


def _tree(policy: str, shape: str, dev, seed: int = 0, ref: bool = False):
    """A tree under ``policy`` shaped as ``SHAPES[shape]``, and the keys it
    was written with; with ``ref`` the reference's tree (``dev`` unused),
    given the same writes."""
    n_imm, n_l0, gap = SHAPES[shape]
    if ref:
        cfg = ref_policy(policy).default_config(SCALE).with_(bloom_fpr=FPR)
        tree = RefTree(cfg)
    else:
        cfg = get_policy(policy).default_config(SCALE).with_(bloom_fpr=FPR)
        tree = LSMTree(cfg, compute_device=dev)
    rng = np.random.default_rng(seed)
    room = tree.memtable.room
    keys = rng.integers(-2 ** 40, 2 ** 40, 24 * room)
    keys[:2] = (LO, HI)
    no = np.zeros(keys.shape[0], bool)
    _fill(tree, keys, no)
    # newer tombstones and rewrites over older values
    _fill(tree, rng.choice(keys, 4 * room), np.ones(4 * room, bool))
    _fill(tree, rng.choice(keys, 4 * room), np.zeros(4 * room, bool))
    if gap:     # move every level from the first non-empty one down by one
        first = next(lv for lv in range(1, cfg.max_levels)
                     if tree.levels[lv])
        last = max(lv for lv in range(cfg.max_levels) if tree.levels[lv])
        assert last + 1 < cfg.max_levels
        for lv in range(last, first - 1, -1):
            tree.levels[lv + 1] = tree.levels[lv]
            tree.index.refresh(lv + 1, tree.levels[lv + 1])
        tree.levels[first] = []
        tree.index.refresh(first, [])
    if n_l0 == "stop":  # flushed without the L0 trigger's compaction
        while len(tree.levels[0]) < tree.policy.l0_stop_ssts(cfg):
            _seal_memtable_of(tree, rng.choice(keys, room),
                              rng.random(room) < 0.3)
            sst = tree.immutables.pop(0).to_sst()
            tree.levels[0].append(sst)
            tree.index.l0_append(sst)
    for _ in range(n_imm):
        _seal_memtable_of(tree, rng.choice(keys, room),
                          rng.random(room) < 0.3)
    half = room // 2
    tree._write_batch(rng.choice(keys, half), rng.random(half) < 0.3)
    return tree, keys


def _queries(tree, keys, seed: int = 1) -> np.ndarray:
    """Present and deleted keys, absent ones, keys at, just below and just
    above every fence, and the int64 extremes."""
    rng = np.random.default_rng(seed)
    fences = np.concatenate([np.concatenate([tree.index.smallest[lv],
                                             tree.index.largest[lv]])
                             for lv in range(tree.cfg.max_levels)])
    edges = np.concatenate([fences, fences[fences > LO] - 1,
                            fences[fences < HI] + 1])
    return np.concatenate([
        [LO, LO + 1, HI - 1, HI, -1, 0, 1], edges,
        rng.choice(keys, 600), rng.integers(-2 ** 40, 2 ** 40, 300),
        rng.integers(LO, HI, 100, endpoint=True)]).astype(np.int64)


def _bloom(key: int, seed: int) -> bool:
    h = (key * 0x9E3779B97F4A7C15 + seed) % (1 << 64) & 0xFFFFFFFF
    return h / float(0xFFFFFFFF) < FPR


def _walk(tree, key: int) -> tuple[int, int, int]:
    """One key's lookup written out: ``(seq, reads, probed)``."""
    def hit(keys, seqs):
        k, s = keys.cpu().numpy(), seqs.cpu().numpy()
        i = int(np.searchsorted(k, key))
        if i < k.shape[0] and k[i] == key:
            return -1 if s[i] & 1 else int(s[i] >> 1)
        return None
    reads = probed = 0
    for mt in [tree.memtable] + tree.immutables[::-1]:
        if mt.n and (got := hit(*mt.to_sorted())) is not None:
            return got, 0, 0
    candidates = [s for s in reversed(tree.levels[0])
                  if s.smallest <= key <= s.largest]
    for lv in range(1, tree.cfg.max_levels):
        ssts = tree.levels[lv]
        j = int(np.searchsorted(tree.index.largest[lv], key))
        if j < len(ssts) and ssts[j].smallest <= key:
            candidates.append(ssts[j])
    for sst in candidates:
        probed += 1
        if (got := hit(sst.keys, sst.seqs)) is not None:
            return got, reads + 1, probed
        reads += _bloom(key, bloom_seed_for_uid(sst.uid))
    return -1, reads, probed


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_run_table_matches_the_tree(policy, shape):
    tree, _ = _tree(policy, shape, "cpu")
    runs = tree.probe_runs()
    table = ops.probe_table(runs)
    mts = [m for m in [tree.memtable] + tree.immutables[::-1] if m.n]
    l0 = tree.levels[0][::-1]
    levels = [lv for lv in range(1, tree.cfg.max_levels) if tree.levels[lv]]
    assert table.shape == (len(mts) + len(l0) + len(levels), ops.RUN_FIELDS)
    kinds = [ops.MEMTABLE] * len(mts) + [ops.L0_SST] * len(l0) \
        + [ops.LEVEL] * len(levels)
    assert table[:, 0].tolist() == kinds
    n_imm, n_l0, gap = SHAPES[shape]
    assert len(mts) == 1 + n_imm
    if n_l0 == "stop":
        assert len(l0) == tree.policy.l0_stop_ssts(tree.cfg)
    if gap:
        assert levels[0] > 1
    for row, mt in zip(table, mts):
        sk, ss = mt.to_sorted()
        assert row.tolist() == [ops.MEMTABLE, sk.data_ptr(), ss.data_ptr(),
                                sk.shape[0], 0, 0, 0, 0]
    for row, sst in zip(table[len(mts):], l0):
        assert row.tolist() == [ops.L0_SST, sst.keys.data_ptr(),
                                sst.seqs.data_ptr(), sst.n, sst.smallest,
                                sst.largest, bloom_seed_for_uid(sst.uid), 0]
    for row, lv in zip(table[len(mts) + len(l0):], levels):
        fkeys, fseqs = tree._flat_level(lv)
        assert fkeys.shape[0] == sum(s.n for s in tree.levels[lv])
        assert row.tolist() == [
            ops.LEVEL, fkeys.data_ptr(), fseqs.data_ptr(), fkeys.shape[0],
            tree.index.dev_smallest[lv].data_ptr(),
            tree.index.dev_largest[lv].data_ptr(),
            tree.index.bloom[lv].data_ptr(), len(tree.levels[lv])]
        np.testing.assert_array_equal(
            tree.index.bloom[lv].numpy(),
            [bloom_seed_for_uid(s.uid) for s in tree.levels[lv]])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_chain_equals_the_walk(policy, shape):
    tree, keys = _tree(policy, shape, "cpu")
    q = _queries(tree, keys)
    launches = ops.lookup_probe.launches
    seqs, reads, probed = tree.get_batch(q)
    assert ops.lookup_probe.launches == launches   # CPU: the plain chain
    want = np.array([_walk(tree, int(k)) for k in q]).T
    np.testing.assert_array_equal(seqs, want[0])
    np.testing.assert_array_equal(reads, want[1])
    np.testing.assert_array_equal(probed, want[2])
    # every kind of outcome occurs
    assert (seqs >= 0).any() and (seqs == -1).any()
    assert (reads > probed - reads).any() and (probed > 1).any()


@pytest.mark.usefixtures("reference_numpy_tiers")
@pytest.mark.parametrize("shape", WRITTEN)
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_chain_equals_the_reference(policy, shape):
    """The same writes to the reference's tree and the port's, each from
    rewound uid counters (uids seed the bloom model): every query key,
    fence edges and int64 extremes included, gets the reference's seq,
    reads and probed."""
    ref_reset()
    ref, keys = _tree(policy, shape, None, ref=True)
    port_reset()
    tree, _ = _tree(policy, shape, "cpu")
    assert [[s.uid for s in lv] for lv in tree.levels] == \
        [[s.uid for s in lv] for lv in ref.levels]
    assert len(tree.immutables) == len(ref.immutables) == SHAPES[shape][0]
    q = _queries(tree, keys)
    got = tree.get_batch(q)
    want = ref.get_batch(q)
    for name, g, w in zip(("seqs", "reads", "probed"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    seqs, reads, probed = got
    assert (seqs >= 0).any() and (seqs == -1).any()
    assert (reads > probed - reads).any() and (probed > 1).any()


def test_empty_tree_and_extremes_on_the_cpu():
    cfg = get_policy("vlsm").default_config(SCALE).with_(bloom_fpr=FPR)
    tree = LSMTree(cfg, compute_device="cpu")
    q = np.array([LO, HI, 0], np.int64)
    assert tree.probe_runs() == []
    seqs, reads, probed = tree.get_batch(q)
    assert seqs.tolist() == [-1] * 3 and reads.tolist() == [0] * 3 \
        and probed.tolist() == [0] * 3
    tree.put_batch(np.array([HI, LO], np.int64))
    assert tree.get_batch(q)[0].tolist() == [1, 0, -1]


def test_probe_rejects_what_the_kernel_cannot_take():
    runs = [ops.ProbeRun(ops.MEMTABLE, torch.arange(4), torch.arange(4))]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.lookup_probe(np.zeros(1, np.int64), runs, FPR,
                         torch.device("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_fused_probe_equals_plain_chain_on_the_card(card, policy, shape):
    tree, keys = _tree(policy, shape, card)
    runs = tree.probe_runs()
    q = _queries(tree, keys)
    for batch in (q, q[:1], q[-1:], q[::-1].copy()):
        launches = ops.lookup_probe.launches
        got = ops.lookup_probe(batch, runs, FPR, card).cpu().numpy()
        assert ops.lookup_probe.launches == launches + 1
        want = ops.lookup_probe_plain(torch.from_numpy(batch).to(card),
                                      runs, FPR).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    seqs, reads, probed = tree.get_batch(q)
    want = np.array([_walk(tree, int(k)) for k in q[:300]]).T
    np.testing.assert_array_equal(seqs[:300], want[0])
    np.testing.assert_array_equal(reads[:300], want[1])
    np.testing.assert_array_equal(probed[:300], want[2])


@pytest.mark.cuda
def test_one_launch_per_get_batch_on_the_card(card):
    tree, keys = _tree("vlsm", "two_immutables", card)
    launches = ops.lookup_probe.launches
    tree.apply_batch(RequestBatch.puts(keys[:5]))
    tree.get_batch(np.zeros(0, np.int64))
    assert ops.lookup_probe.launches == launches    # no GET, no launch
    tree.get_batch(keys[:1])
    tree.apply_batch(RequestBatch.gets(keys[:700]))
    assert ops.lookup_probe.launches == launches + 2
    empty = LSMTree(tree.cfg, compute_device=card)
    assert empty.get_batch(keys[:3])[0].tolist() == [-1] * 3
    assert ops.lookup_probe.launches == launches + 3
