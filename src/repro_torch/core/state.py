"""Fill a port :class:`~repro_torch.core.lsm.LSMTree` from a store state given
as plain numpy arrays — for instance one captured from the JAX package's
reference tree — so that both trees continue from the same structure.

``arrays`` holds::

    "levels":      per level, a list of {"keys", "seqs", "uid"} SSTs
                   (keys sorted and unique, seqs tombstone-encoded)
    "memtable":    the active memtable's (keys, seqs) append chunks
    "immutables":  per sealed memtable, its (keys, seqs) chunks, oldest first
    "seq":         the next logical seqno
    "next_sst_uid", "next_job_uid", "next_chain_id":
                   the positions of the uid counters the tree draws from

The state must be taken between structural passes (no pending jobs).  The
tree's Stats ledger is left as it is.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import lsm as lsm_mod
from . import sst as sst_mod
from .lsm import LSMTree
from .sst import SST


def _device_pair(keys, seqs, dev: torch.device):
    both = torch.from_numpy(np.stack([np.asarray(keys, np.int64),
                                      np.asarray(seqs, np.int64)])).to(dev)
    return both[0], both[1]


def load_tree_state(tree: LSMTree, arrays: dict) -> None:
    """Replace ``tree``'s structure and uid positions with ``arrays``."""
    dev = tree.compute_device
    cfg = tree.cfg
    assert len(arrays["levels"]) == cfg.max_levels, "level count mismatch"
    for level, ssts in enumerate(arrays["levels"]):
        built = []
        for s in ssts:
            keys, seqs = _device_pair(s["keys"], s["seqs"], dev)
            keys_np = np.asarray(s["keys"], np.int64)
            built.append(SST(keys, seqs, cfg.kv_size, uid=int(s["uid"]),
                             bounds=(int(keys_np[0]), int(keys_np[-1]))))
        tree.levels[level] = built
        tree.index.refresh(level, built)

    def memtable_of(chunks):
        mt = tree._new_memtable()
        for keys, seqs in chunks:
            mt.put_batch(*_device_pair(keys, seqs, dev))
        return mt

    tree.memtable = memtable_of(arrays["memtable"])
    tree.immutables = [memtable_of(c) for c in arrays["immutables"]]
    tree.seq = int(arrays["seq"])
    tree.pending_jobs = []
    tree._flat.clear()

    sst_next = itertools.count(int(arrays["next_sst_uid"]))
    if (tree.shard_id, tree.region_id) != (0, 0):
        tree._sst_uids = sst_next
    elif tree._uids is not None:
        tree._uids.sst_ids = tree._sst_uids = sst_next
    else:
        sst_mod._ids = sst_next
    jobs = itertools.count(int(arrays["next_job_uid"]))
    chains = itertools.count(int(arrays["next_chain_id"]))
    if tree._uids is not None:
        tree._uids.job_ids, tree._uids.chain_ids = jobs, chains
    else:
        lsm_mod._job_ids, lsm_mod._chain_ids = jobs, chains
