"""Keyspace sharding: ``ShardRouter`` + ``ShardedStore`` over N LSM trees.

* :class:`ShardRouter` — a vectorized key -> shard partition function.
  ``"hash"`` mixes the key through a splitmix64 finalizer (load spreads
  evenly, ranges scatter across shards); ``"range"`` stripes the key
  domain ``[0, shard_key_space)`` into contiguous shards (scan-friendly,
  skew-prone).  Routing is host-side control (one numpy pass per batch),
  as in the reference.

* :class:`ShardedStore` — N per-shard :class:`~repro_torch.core.lsm.LSMTree`
  instances on one ``compute_device`` behind the same typed
  :class:`~repro_torch.core.types.RequestBatch` entry point as a bare
  tree.  A batch is split into one sub-batch per shard (PUT/GET/DELETE
  route to exactly one shard; SCAN fans out to every shard and the
  per-shard windows are merged by key), applied, and the per-op results
  are re-gathered **in arrival order**, so callers cannot tell how many
  shards sit behind the store — except through the per-shard stats.  With
  ``n_shards=1`` the store is identical to a bare ``LSMTree``.

Time does not live here: the DES (:mod:`repro_torch.core.sim`) drives the
shards' fills/flushes itself through per-shard foreground queues over a
*shared* device.  ``ShardedStore`` is the structural container plus the
standalone (harness-free) store API.
"""

from __future__ import annotations

import numpy as np
import torch

from .lsm import Job, LSMTree
from .stats import FleetStats, Stats
from .types import LSMConfig, OpKind, RequestBatch, ResultBatch


def hash_keys(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over int64 keys -> uint64 mix.

    The standard 64-bit avalanche (shift-xor / odd-constant multiply
    rounds): adjacent keys land on unrelated shards, so range-local load
    cannot pile onto one shard under the hash router.
    """
    x = np.asarray(keys, np.int64).astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class ShardRouter:
    """The keyspace partition function: ``shard_of(keys) -> shard ids``.

    Deterministic, vectorized, and a *partition*: every key maps to
    exactly one shard in ``[0, n_shards)`` (property-tested).
    """

    def __init__(self, n_shards: int, kind: str = "hash",
                 key_space: int = 1 << 48):
        assert n_shards >= 1
        assert kind in ("hash", "range"), f"unknown router kind {kind!r}"
        self.n_shards = int(n_shards)
        self.kind = kind
        self.key_space = int(key_space)
        # range stripe width, rounded up so stripe*n covers the domain
        self._stripe = max(1, -(-self.key_space // self.n_shards))

    @staticmethod
    def from_config(cfg: LSMConfig) -> "ShardRouter":
        return ShardRouter(cfg.n_shards, cfg.shard_router,
                           cfg.shard_key_space)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Shard id (int64) for each key — one columnar pass."""
        keys = np.asarray(keys, np.int64)
        if self.n_shards == 1:
            return np.zeros(keys.shape[0], np.int64)
        if self.kind == "hash":
            return (hash_keys(keys) % np.uint64(self.n_shards)) \
                .astype(np.int64)
        # range: contiguous stripes; keys outside the declared domain
        # clamp to the edge shards instead of wrapping
        return np.clip(keys // self._stripe, 0, self.n_shards - 1)


class ShardedStore:
    """N per-shard LSM trees behind one typed batch entry point.

    Each shard owns its own :class:`~repro_torch.core.stats.Stats` ledger
    (the per-shard observability the fleet report aggregates);
    ``self.stats`` is shard 0's ledger when ``n_shards == 1`` (bare-tree
    parity) and a read-only :class:`~repro_torch.core.stats.FleetStats`
    aggregate otherwise.  Every shard's tree keeps its arrays on
    ``compute_device`` (default ``"cuda"``; ``"cpu"`` runs the kernels'
    plain versions).

    Maintenance (seal/flush/compaction-trigger) is explicit — the DES
    owns *when* those happen; standalone users call
    :meth:`seal_full_memtables` (or :meth:`flush_shard`) between batches,
    mirroring how a bare ``LSMTree`` is driven.
    """

    def __init__(self, cfg: LSMConfig,
                 shard_stats: list[Stats] | None = None,
                 compute_device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.n_shards = cfg.n_shards
        self.router = ShardRouter.from_config(cfg)
        if shard_stats is None:
            shard_stats = [Stats() for _ in range(self.n_shards)]
        assert len(shard_stats) == self.n_shards
        self.shard_stats = shard_stats
        self.shards = [LSMTree(cfg, st, shard_id=s,
                               compute_device=compute_device)
                       for s, st in enumerate(shard_stats)]
        self.compute_device = self.shards[0].compute_device
        self.stats: Stats | FleetStats = shard_stats[0] \
            if self.n_shards == 1 else FleetStats(shard_stats)
        # Background jobs drained by the store's own memtable rolls (a
        # standalone store has no clock — the DES never ingests through
        # here, so jobs are a structural record for callers/tests).
        self.job_log: list[Job] = []

    # --------------------------------------------------- typed entry point
    def apply_batch(self, batch: RequestBatch) -> ResultBatch:
        """Route one typed batch to the shards and re-gather the results.

        Vectorized columnar routing: ``router.shard_of(keys)`` in one
        pass, then one sub-batch per touched shard.  PUT/DELETE ops go to
        exactly their key's shard (chunked at the shard memtable's
        capacity, rolling full memtables through flush, exactly as a
        harness seals a bare tree on its fill events); GETs go to their
        key's shard; SCAN ops fan out to **every** shard (a range crosses
        hash shards arbitrarily) and the per-shard windows — disjoint by
        the partition property — are merged by key, keeping the first
        ``scan_lens[i]`` live keys.  Writes land first, then the batch's
        reads observe post-write state (the ``LSMTree.apply_batch``
        contract, fleet-wide).  Results land back at their op's arrival
        position, so the gather is order-preserving by construction.
        """
        n = len(batch)
        kinds = batch.kinds
        shard_ids = self.router.shard_of(batch.keys)
        seqs_out = np.full(n, -1, np.int64)
        reads = np.zeros(n, np.int32)
        probed = np.zeros(n, np.int32)
        offsets = np.zeros(n + 1, np.int64)
        is_write = batch.mask(OpKind.PUT, OpKind.DELETE)
        is_get = batch.mask(OpKind.GET)
        is_scan = batch.mask(OpKind.SCAN)
        # 1. writes, per shard, in arrival order within the shard
        for s in range(self.n_shards):
            widx = np.nonzero(is_write & (shard_ids == s))[0]
            if widx.shape[0] == 0:
                continue
            assigned = self._ingest(s, batch.keys[widx],
                                    kinds[widx] == OpKind.DELETE)
            seqs_out[widx] = assigned
            batch.seqnos[widx] = assigned
        # 2. point reads, per shard
        for s in range(self.n_shards):
            gidx = np.nonzero(is_get & (shard_ids == s))[0]
            if gidx.shape[0] == 0:
                continue
            res = self.shards[s].apply_batch(
                RequestBatch.gets(batch.keys[gidx]))
            seqs_out[gidx] = res.seqs
            reads[gidx] = res.reads
            probed[gidx] = res.probed
        # 3. scans fan out to every shard; merge the disjoint windows
        out_k: list[np.ndarray] = [np.empty(0, np.int64)] * n
        out_s: list[np.ndarray] = [np.empty(0, np.int64)] * n
        if is_scan.any():
            sidx = np.nonzero(is_scan)[0]
            for s in range(self.n_shards):
                res = self.shards[s].apply_batch(RequestBatch.scans(
                    batch.keys[sidx], batch.scan_lens[sidx]))
                for p, g in enumerate(sidx.tolist()):
                    ks, ss = res.scan_slice(p)
                    if ks.shape[0]:
                        out_k[g] = np.concatenate([out_k[g], ks])
                        out_s[g] = np.concatenate([out_s[g], ss])
                    reads[g] += int(res.reads[p])
                    probed[g] += int(res.probed[p])
            for g in sidx.tolist():
                # shards partition the keyspace -> windows are disjoint;
                # merge = sort by key, keep the first `want` live keys
                order = np.argsort(out_k[g], kind="stable")
                take = order[:int(batch.scan_lens[g])]
                out_k[g] = out_k[g][take]
                out_s[g] = out_s[g][take]
                seqs_out[g] = int(take.shape[0])
            lens = np.zeros(n, np.int64)
            lens[sidx] = [out_k[int(g)].shape[0] for g in sidx]
            np.cumsum(lens, out=offsets[1:])
            scan_keys = np.concatenate(out_k)
            scan_seqs = np.concatenate(out_s)
        else:
            scan_keys = scan_seqs = np.empty(0, np.int64)
        return ResultBatch(kinds, seqs_out, reads, probed, offsets,
                           scan_keys, scan_seqs)

    def _ingest(self, shard: int, keys: np.ndarray,
                tombs: np.ndarray) -> np.ndarray:
        """Write keys/tombstones into one shard, chunked at the memtable's
        capacity; a memtable that fills rolls immediately (seal -> flush
        -> background triggers), mirroring a harness's fill events."""
        tree = self.shards[shard]
        n = int(keys.shape[0])
        seqs = np.empty(n, np.int64)
        i = 0
        while i < n:
            if tree.memtable.room == 0:
                self._roll_memtable(shard)
            take = min(tree.memtable.room, n - i)
            seqs[i:i + take] = tree._write_batch(keys[i:i + take],
                                                 tombs[i:i + take])
            i += take
            if tree.memtable.full:
                self._roll_memtable(shard)
        return seqs

    def _roll_memtable(self, shard: int) -> None:
        tree = self.shards[shard]
        tree.seal_memtable()
        tree.flush_immutable()
        tree.background_triggers()
        self.job_log.extend(tree.drain_jobs())

    # ------------------------------------------------------- thin wrappers
    def put_batch(self, keys: np.ndarray) -> np.ndarray:
        return self.apply_batch(RequestBatch.puts(keys)).seqs

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        return self.apply_batch(RequestBatch.deletes(keys)).seqs

    def get_batch(self, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        res = self.apply_batch(RequestBatch.gets(keys))
        return res.seqs, res.reads, res.probed

    def scan_batch(self, start_keys: np.ndarray,
                   lengths: np.ndarray) -> ResultBatch:
        return self.apply_batch(RequestBatch.scans(start_keys, lengths))

    # -------------------------------------------------------- maintenance
    def seal_full_memtables(self) -> list[Job]:
        """Standalone maintenance: seal + flush every shard whose active
        memtable is full (the cadence a harness-free caller drives between
        batches, mirroring how a bare tree is sealed when full); returns
        the drained background jobs of all shards, shard order."""
        jobs: list[Job] = []
        for s, tree in enumerate(self.shards):
            if tree.memtable.full:
                jobs.extend(self.flush_shard(s))
        return jobs

    def flush_shard(self, shard: int) -> list[Job]:
        """Seal/flush one shard's active memtable (even part-full) and run
        its background triggers; returns the drained jobs."""
        tree = self.shards[shard]
        if tree.memtable.n == 0 and not tree.immutables:
            return []
        if tree.memtable.n > 0:
            tree.seal_memtable()
        while tree.immutables:
            tree.flush_immutable()
        tree.background_triggers()
        return tree.drain_jobs()

    def drain_jobs(self) -> list[Job]:
        out: list[Job] = []
        for tree in self.shards:
            out.extend(tree.drain_jobs())
        return out

    # -------------------------------------------------------------- misc
    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        return self.router.shard_of(keys)

    def total_keys(self) -> int:
        return sum(t.total_keys() for t in self.shards)

    def level_sizes(self) -> list[list[int]]:
        """Per-shard level byte sizes (shard-major)."""
        return [t.level_sizes() for t in self.shards]

    def merged_view(self) -> dict[int, int]:
        """Union of the shards' live views — disjoint by the partition."""
        view: dict[int, int] = {}
        for t in self.shards:
            view.update(t.merged_view())
        return view

    def check_invariants(self) -> None:
        for t in self.shards:
            t.check_invariants()
