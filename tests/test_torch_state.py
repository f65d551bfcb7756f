"""State carried across: a reference tree's structure is handed to the port
as numpy arrays (``repro_torch.core.state.load_tree_state``); both trees
then apply the same further typed batches — PUT, DELETE, GET and SCAN, with
flushes and compaction chains in between — and must stay identical."""

import numpy as np
import pytest

import repro.core.lsm as ref_lsm_mod
import repro.core.sst as ref_sst_mod
from repro.core import LSMTree as RefTree
from repro.core import RequestBatch as RefBatch
from repro.core import get_policy as ref_policy
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.core import LSMTree, RequestBatch, get_policy
from repro_torch.core.state import load_tree_state
from repro_torch.core.uids import reset_uid_counters as port_reset
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 17


def _position(counter) -> int:
    """Next value of an itertools.count, read without advancing it."""
    return int(repr(counter)[len("count("):-1])


def _reference_state(tree) -> dict:
    return {
        "levels": [[{"keys": s.keys, "seqs": s.seqs, "uid": s.uid}
                    for s in lvl] for lvl in tree.levels],
        "memtable": list(zip(tree.memtable._keys, tree.memtable._seqs)),
        "immutables": [list(zip(m._keys, m._seqs)) for m in tree.immutables],
        "seq": tree.seq,
        "next_sst_uid": _position(ref_sst_mod._ids),
        "next_job_uid": _position(ref_lsm_mod._job_ids),
        "next_chain_id": _position(ref_lsm_mod._chain_ids),
    }


def _step(tree, batch_cls, rng_state, n_pop_keys):
    """One typed batch (writes fit the memtable's room), then the DES's
    maintenance once the memtable has no room left.  Returns the result batch."""
    rng = np.random.default_rng(rng_state)
    n_w = min(tree.memtable.room, int(rng.integers(20, 120)))
    kinds = np.concatenate([
        np.where(rng.random(n_w) < 0.15, 2, 0),            # PUT / DELETE
        np.ones(40, np.int64),                             # GET
        np.full(5, 3),                                     # SCAN
    ]).astype(np.uint8)
    keys = rng.choice(n_pop_keys, kinds.shape[0])
    scan_lens = np.where(kinds == 3, rng.integers(1, 30, kinds.shape[0]), 0)
    res = tree.apply_batch(batch_cls(kinds, keys, scan_lens))
    if tree.memtable.room == 0:
        tree.seal_memtable()
        tree.flush_immutable()
        tree.background_triggers()
        tree.drain_jobs()
    return res


@pytest.mark.parametrize("pname", ["vlsm", "rocksdb", "rocksdb_io", "adoc",
                                   "lsmi", "lazy"])
def test_state_transfer_then_identical_evolution(pname):
    rng = np.random.default_rng(3)
    pop = np.unique(rng.integers(0, 1 << 40, 6_000)).astype(np.int64)
    ref_reset()
    ref = RefTree(ref_policy(pname).default_config(SCALE))
    for i in range(60):                      # build the reference state
        _step(ref, RefBatch, i, pop)
    assert any(ref.levels[1:]), "the warm-up must reach L1"

    port_reset()
    port = LSMTree(get_policy(pname).default_config(SCALE),
                   compute_device="cpu")
    load_tree_state(port, _reference_state(ref))
    port.check_invariants()
    assert port.merged_view() == ref.merged_view()

    for i in range(60, 140):
        want = _step(ref, RefBatch, i, pop)
        got = _step(port, RequestBatch, i, pop)
        for name in ("kinds", "seqs", "reads", "probed", "scan_offsets",
                     "scan_keys", "scan_seqs"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
    for ref_lvl, lvl in zip(ref.levels, port.levels, strict=True):
        assert [(s.uid, s.smallest, s.largest) for s in lvl] == \
            [(s.uid, s.smallest, s.largest) for s in ref_lvl]
        for ref_sst, sst in zip(ref_lvl, lvl):
            np.testing.assert_array_equal(sst.seqs.numpy(), ref_sst.seqs)
    assert port.merged_view() == ref.merged_view()
    assert port.stats.tombstones_dropped == ref.stats.tombstones_dropped
    assert port.stats.scan_ops == ref.stats.scan_ops
