"""The port's ``ShardedStore`` against the JAX package's reference on the CPU
(``compute_device="cpu"``), for every registered policy, at the reference's
test size (``tests/test_shard.py``: scale 1 << 17, 6,000 mixed writes with
5% DELETEs, GETs and SCANs of 1-39 keys between them).

Everything structural must be equal exactly: every ``ResultBatch`` field of
every batch, ``merged_view``, each shard's SSTs, Stats and chain ledger.  The
reference runs on its numpy tiers (``tests/_torch_parity.py``); both sides
rewind their uid counters first, as uids seed the bloom model.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import RequestBatch as RefRequestBatch
from repro.core import ShardedStore as RefShardedStore
from repro.core import get_policy as ref_policy
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.core import (LSMConfig, LSMTree, OpKind, RequestBatch,
                              ShardedStore, get_policy)
from repro_torch.core.stats import FleetStats
from repro_torch.core.uids import reset_uid_counters as port_reset
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 17
POLICIES = ("vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi", "lazy")
RESULT_FIELDS = ("kinds", "seqs", "reads", "probed", "scan_offsets",
                 "scan_keys", "scan_seqs")


def _mixed_ops(seed=5, n_writes=6_000):
    """The reference's ``tests/test_shard.py::_mixed_ops`` stream."""
    r = np.random.default_rng(seed)
    pool = r.integers(0, 1 << 40, n_writes, dtype=np.int64)
    ops = []
    for lo in range(0, n_writes, 1_000):
        chunk = pool[lo:lo + 1_000]
        tombs = r.random(chunk.shape[0]) < 0.05
        ops.append(("write", (chunk, tombs)))
        ops.append(("get", r.choice(pool[:lo + 1_000], 300)))
        starts = r.choice(pool[:lo + 1_000], 5)
        lens = r.integers(1, 40, 5).astype(np.int32)
        ops.append(("scan", (starts, lens)))
    return ops


def _drive(store, batch_cls, ops, seal: bool = False):
    """Every batch through ``apply_batch``; ``seal`` also runs the
    harness-free maintenance between batches."""
    results = []
    for kind, payload in ops:
        if kind == "write":
            keys, tombs = payload
            kinds = np.where(tombs, np.uint8(OpKind.DELETE),
                             np.uint8(OpKind.PUT))
            results.append(store.apply_batch(batch_cls(kinds, keys)))
        elif kind == "get":
            results.append(store.apply_batch(batch_cls.gets(payload)))
        else:
            results.append(store.apply_batch(batch_cls.scans(*payload)))
        if seal:
            store.seal_full_memtables()
    return results


def _stats_fields(st) -> dict:
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if f.name not in ("chains", "chain_index")}


@pytest.mark.parametrize("n_shards,router", [(1, "hash"), (2, "hash"),
                                             (2, "range"), (4, "hash"),
                                             (4, "range")])
@pytest.mark.parametrize("policy", POLICIES)
def test_store_equals_reference(policy, n_shards, router):
    ops = _mixed_ops()
    kw = dict(n_shards=n_shards, shard_router=router,
              shard_key_space=1 << 40)
    ref_reset()
    ref = RefShardedStore(ref_policy(policy).default_config(SCALE)
                          .with_(**kw))
    want = _drive(ref, RefRequestBatch, ops, seal=True)
    want.append(ref.drain_jobs())
    port_reset()
    store = ShardedStore(get_policy(policy).default_config(SCALE)
                         .with_(**kw), compute_device="cpu")
    got = _drive(store, RequestBatch, ops, seal=True)
    got.append(store.drain_jobs())
    for g, w in zip(got[:-1], want[:-1], strict=True):
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
    assert [(j.kind, j.level, j.uid, j.shard) for j in got[-1]] == \
        [(j.kind, j.level, j.uid, j.shard) for j in want[-1]]
    assert [(j.kind, j.level, j.uid, j.shard) for j in store.job_log] == \
        [(j.kind, j.level, j.uid, j.shard) for j in ref.job_log]
    assert store.merged_view() == ref.merged_view()
    assert store.total_keys() == ref.total_keys()
    assert store.level_sizes() == ref.level_sizes()
    for tree, ref_tree in zip(store.shards, ref.shards, strict=True):
        for lvl, ref_lvl in zip(tree.levels, ref_tree.levels, strict=True):
            assert [s.uid for s in lvl] == [s.uid for s in ref_lvl]
            for sst, ref_sst in zip(lvl, ref_lvl):
                np.testing.assert_array_equal(sst.keys.numpy(), ref_sst.keys)
                np.testing.assert_array_equal(sst.seqs.numpy(), ref_sst.seqs)
    for st, ref_st in zip(store.shard_stats, ref.shard_stats, strict=True):
        assert _stats_fields(st) == _stats_fields(ref_st)
        assert [dataclasses.asdict(c) for c in st.chains] == \
            [dataclasses.asdict(c) for c in ref_st.chains]
    store.check_invariants()
    if n_shards > 1:
        assert isinstance(store.stats, FleetStats)
        assert sum(len(t.merged_view()) for t in store.shards) == \
            len(store.merged_view())


@pytest.mark.parametrize("policy", POLICIES)
def test_single_shard_store_equals_bare_tree(policy):
    """``ShardedStore(n_shards=1)`` equals a bare ``LSMTree`` driven with
    the same seal-on-full cadence: results, merged_view, chain ledger."""
    cfg = get_policy(policy).default_config(scale=SCALE)
    ops = _mixed_ops()
    port_reset()
    tree = LSMTree(cfg, compute_device="cpu")
    t_res = []
    for kind, payload in ops:
        if kind == "write":
            keys, tombs = payload
            i, n = 0, keys.shape[0]
            while i < n:
                if tree.memtable.room == 0:
                    tree.seal_memtable()
                    tree.flush_immutable()
                    tree.background_triggers()
                    tree.drain_jobs()
                take = min(tree.memtable.room, n - i)
                tree._write_batch(keys[i:i + take], tombs[i:i + take])
                i += take
                if tree.memtable.full:
                    tree.seal_memtable()
                    tree.flush_immutable()
                    tree.background_triggers()
                    tree.drain_jobs()
        elif kind == "get":
            t_res.append(tree.apply_batch(RequestBatch.gets(payload)))
        else:
            t_res.append(tree.apply_batch(RequestBatch.scans(*payload)))
    port_reset()
    store = ShardedStore(cfg.with_(n_shards=1), compute_device="cpu")
    s_res = [r for (kind, _), r in zip(ops, _drive(store, RequestBatch, ops))
             if kind != "write"]
    assert store.merged_view() == tree.merged_view()
    for tr, sr in zip(t_res, s_res, strict=True):
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(sr, f), getattr(tr, f),
                                          err_msg=f)
    assert store.stats is store.shard_stats[0]
    assert [(c.chain_id, c.trigger, c.length, c.width, c.job_uids)
            for c in store.stats.chains] == \
        [(c.chain_id, c.trigger, c.length, c.width, c.job_uids)
         for c in tree.stats.chains]


def test_check_invariants_and_partition():
    """Every key lives in the shard the router names; invariants hold
    after flushing every shard; shuffled GETs answer at their positions."""
    cfg = LSMConfig.vlsm_default(scale=SCALE).with_(n_shards=4)
    store = ShardedStore(cfg, compute_device="cpu")
    r = np.random.default_rng(11)
    keys = np.unique(r.integers(0, 1 << 40, 5_000, dtype=np.int64))
    store.put_batch(keys)
    store.delete_batch(keys[:50])
    for s in range(store.n_shards):
        store.flush_shard(s)
    store.check_invariants()
    live_keys = keys[50:]
    sid = store.shard_of(live_keys)
    for s, tree in enumerate(store.shards):
        assert set(live_keys[sid == s].tolist()) == set(tree.merged_view())
    probe = r.permutation(keys[50:])[:1_000]
    seqs, reads, probed = store.get_batch(probe)
    expect = store.merged_view()
    assert [expect[int(k)] for k in probe.tolist()] == seqs.tolist()
    assert (store.get_batch(keys[:50])[0] == -1).all()
    res = store.scan_batch(probe[:4], np.full(4, 30, np.int32))
    live = np.array(sorted(expect), np.int64)
    for i, k in enumerate(probe[:4].tolist()):
        ks, _ = res.scan_slice(i)
        np.testing.assert_array_equal(ks, live[live >= k][:30])


def test_store_runs_on_the_card_unless_asked():
    cfg = LSMConfig.vlsm_default(scale=SCALE).with_(n_shards=2)
    if torch.cuda.is_available():
        assert ShardedStore(cfg).compute_device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        ShardedStore(cfg)
