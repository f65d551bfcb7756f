"""The LSM *mechanism* engine: memtable, flush, splice, merge, read paths.

Structural state (which SSTs live where) mutates *eagerly* when a compaction
is triggered; *time* is owned by the discrete-event simulation in
``repro_torch.core.sim``, which schedules the :class:`Job` records emitted
here.  The store's merge work is real — actual sorted-array merges over
actual keys, on the compute device — while staying deterministic and
replayable.

Placement: memtable chunks, SST payloads, each level's flat key/seq cache
and the LevelIndex fence/bloom arrays are int64 tensors on the compute
device; jobs, chain records, Stats and every policy decision stay on the
host.  A window's GET batch goes to the device in one transfer, is resolved
there by one launch of the fused probe with no host reads, and comes back
in one transfer.

This module is **policy-agnostic**: every compaction decision is delegated
to the ``CompactionPolicy`` object resolved from ``cfg.policy``; the
strategy hooks call back into the mechanism primitives exposed here:
:meth:`LSMTree.overlap`, :meth:`LSMTree.merge_runs`,
:meth:`LSMTree.merge_down`, :meth:`LSMTree.replace_in_level`,
:meth:`LSMTree.strip_bottom_tombstones` and :meth:`LSMTree.emit_compact_job`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.overlap_scan.ops import (L0_SST, LEVEL, MEMTABLE,
                                        ProbeRun, fence_rank,
                                        lookup_probe)
from ..trace import span
from . import merge as merge_backend
from .level_index import LevelIndex, bloom_seed_for_uid
from .memtable import Memtable
from .policies import get_policy
from .sst import SST, split_fixed, total_size, uid_allocator
from .stats import ChainRecord, Stats
from .types import (LSMConfig, OpKind, RequestBatch, ResultBatch,
                    resolve_compute_device, seq_encode)
from .uids import UidNamespace

_job_ids = itertools.count()
# Chain ids are module-global (not per-tree): a Simulator shares one Stats
# ledger across regions, so chain identity must be unique across trees.
_chain_ids = itertools.count()


@dataclass
class Job:
    """A unit of background device work, scheduled by the DES.

    ``chain_id`` names the compaction chain (or, for flushes, a fresh
    singleton id) and ``parent_job`` is the intra-chain predecessor this
    job's start must wait for (``None`` for the chain's deepest stage).
    """

    kind: str                    # "flush" | "compact"
    level: int                   # source level (-1 for memtable flush)
    bytes_read: int
    bytes_written: int
    n_in_ssts: int
    n_out_ssts: int
    deps: list["Job"] = field(default_factory=list)
    uid: int = field(default_factory=lambda: next(_job_ids))
    l0_consumed: int = 0         # L0 SSTs this job removed (for the DES)
    chain_id: int = -1           # the chain this job belongs to
    parent_job: "Job | None" = None  # intra-chain predecessor (dep edge)
    shard: int = 0               # shard of the emitting tree (fleet DES)
    # filled by the DES:
    t_start: float = 0.0
    t_finish: float = 0.0
    scheduled: bool = False

    @property
    def total_bytes(self) -> int:
        return self.bytes_read + self.bytes_written


class LSMTree:
    """A single shard/region's LSM index on one compute device.

    ``shard_id``/``region_id`` name the tree's place in a sharded fleet
    (both 0 for a standalone tree); every emitted :class:`Job` is stamped
    with the tree's ``shard_id``.  ``compute_device`` is the torch device
    of the tree's arrays (default ``"cuda"``; ``"cpu"`` runs the plain
    PyTorch tier).
    """

    def __init__(self, cfg: LSMConfig, stats: Stats | None = None,
                 shard_id: int = 0, region_id: int = 0,
                 uids: UidNamespace | None = None,
                 compute_device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.compute_device = resolve_compute_device(compute_device)
        self.policy = get_policy(cfg.policy)
        self.stats = stats if stats is not None else Stats()
        self.shard_id = shard_id
        self.region_id = region_id
        self.memtable = self._new_memtable()
        self.immutables: list[Memtable] = []
        # levels[0] is L0: FIFO, newest LAST; overlapping allowed.
        # levels[i>=1]: sorted by key, pairwise disjoint.
        self.levels: list[list[SST]] = [[] for _ in range(cfg.max_levels)]
        self.index = LevelIndex(cfg.max_levels, self.compute_device)
        self.seq = 0
        self.pending_jobs: list[Job] = []
        self._active_chain = -1
        # SST uid source: tree slot 0 keeps the process-global counter (or
        # the engine's namespace); every other tree of a fleet draws from
        # its own disjoint base, as in the reference.
        self._uids = uids
        slot = (shard_id << 12) | region_id
        if slot != 0:
            self._sst_uids = itertools.count(slot << 40)
        else:
            self._sst_uids = uids.sst_ids if uids is not None else None
        # Lazy flat concatenation of each sorted level's keys/seqs (the GET
        # path probes a whole level with ONE rank); invalidated by the
        # LevelIndex per-level version counters.
        self._flat: dict[int, tuple[int, torch.Tensor, torch.Tensor]] = {}

    def _new_memtable(self) -> Memtable:
        return Memtable(self.cfg.memtable_size, self.cfg.kv_size,
                        self.compute_device)

    def _next_job_uid(self) -> int:
        return next(self._uids.job_ids if self._uids is not None
                    else _job_ids)

    def _next_chain_id(self) -> int:
        return next(self._uids.chain_ids if self._uids is not None
                    else _chain_ids)

    # --------------------------------------------------- typed entry point
    def apply_batch(self, batch: RequestBatch) -> ResultBatch:
        """THE operation entry point: apply one typed request batch.

        Writes (PUT + DELETE, in array order) land first, then GETs and
        SCANs observe the post-write state.  Assigned seqnos are also
        written back into ``batch.seqnos``.
        """
        with span("store.apply"):
            kinds = batch.kinds
            n = len(batch)
            seqs_out = np.full(n, -1, np.int64)
            reads = np.zeros(n, np.int32)
            probed = np.zeros(n, np.int32)
            offsets = np.zeros(n + 1, np.int64)
            scan_keys = scan_seqs = np.empty(0, np.int64)
            w = batch.mask(OpKind.PUT, OpKind.DELETE)
            if w.any():
                widx = np.nonzero(w)[0]
                assigned = self._write_batch(batch.keys[widx],
                                             kinds[widx] == OpKind.DELETE)
                seqs_out[widx] = assigned
                batch.seqnos[widx] = assigned
            g = kinds == OpKind.GET
            if g.any():
                gidx = np.nonzero(g)[0]
                s, r, p = self._lookup_batch(batch.keys[gidx])
                seqs_out[gidx] = s
                reads[gidx] = r
                probed[gidx] = p
            sc = kinds == OpKind.SCAN
            if sc.any():
                sidx = np.nonzero(sc)[0]
                counts, r, p, scan_keys, scan_seqs = self._scan_impl(
                    batch.keys[sidx], batch.scan_lens[sidx])
                seqs_out[sidx] = counts
                reads[sidx] = r
                probed[sidx] = p
                lens = np.zeros(n, np.int64)
                lens[sidx] = counts
                np.cumsum(lens, out=offsets[1:])
            return ResultBatch(kinds, seqs_out, reads, probed, offsets,
                               scan_keys, scan_seqs)

    # ------------------------------------------------------------ ingest
    def put_batch(self, keys: np.ndarray) -> np.ndarray:
        """Insert keys (must fit in the active memtable); returns their seqs."""
        return self.apply_batch(RequestBatch.puts(keys)).seqs

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        """Write DELETE tombstones for keys; returns their seqs."""
        return self.apply_batch(RequestBatch.deletes(keys)).seqs

    def _write_batch(self, keys: np.ndarray, tombs: np.ndarray) -> np.ndarray:
        """Append PUT/DELETE entries in array order; returns logical seqs.
        Keys and encoded seqs go to the device in one transfer."""
        with span("store.write"):
            n = int(keys.shape[0])
            assert n <= self.memtable.room, \
                "caller must chunk at memtable capacity"
            seqs = np.arange(self.seq, self.seq + n, dtype=np.int64)
            self.seq += n
            tombs = np.asarray(tombs, bool)
            both = torch.from_numpy(np.stack([np.asarray(keys, np.int64),
                                              seq_encode(seqs, tombs)]))
            both = both.to(self.compute_device)
            self.memtable.put_batch(both[0], both[1])
            self.stats.user_bytes += n * self.cfg.kv_size
            self.stats.ops += n
            self.stats.delete_ops += int(tombs.sum())
            return seqs

    def seal_memtable(self) -> None:
        assert self.memtable.full or self.memtable.n > 0
        self.immutables.append(self.memtable)
        self.memtable = self._new_memtable()

    def flush_immutable(self) -> tuple[Job, list[Job]]:
        """Flush the oldest immutable memtable to L0.

        Returns ``(flush_job, chain_jobs)``: the flush itself, plus any
        compaction chain triggered because L0 was at its compaction trigger.
        """
        with span("store.flush"), uid_allocator(self._sst_uids):
            return self._flush_immutable()

    def _flush_immutable(self) -> tuple[Job, list[Job]]:
        chain_jobs: list[Job] = []
        l0 = self.levels[0]
        if len(l0) >= self.cfg.l0_max_ssts:
            chain_jobs = self._compact_l0_trigger()
        blocking: list[Job] = []
        if (len(self.levels[0]) >= self.policy.l0_stop_ssts(self.cfg)
                and chain_jobs):
            blocking = [chain_jobs[-1]]  # chain head: the L0 compaction
        mt = self.immutables.pop(0)
        sst = mt.to_sst()
        if sst.n == 0:
            job = Job("flush", -1, 0, 0, 0, 0, deps=blocking,
                      uid=self._next_job_uid(),
                      chain_id=self._next_chain_id(), shard=self.shard_id)
            self.pending_jobs.append(job)
            return job, chain_jobs
        self.levels[0].append(sst)
        self.index.l0_append(sst)
        self.stats.flush_bytes += sst.size
        self.stats.ssts_created += 1
        self.stats.manifest_flushes += 1
        job = Job("flush", -1, 0, sst.size, 0, 1, deps=blocking,
                  uid=self._next_job_uid(),
                  chain_id=self._next_chain_id(), shard=self.shard_id)
        self.pending_jobs.append(job)
        return job, chain_jobs

    # ------------------------------------------------------- compactions
    def _compact_l0_trigger(self) -> list[Job]:
        """L0 is at its trigger: run the policy's L0 compaction until the
        file count is back below the trigger, one chain per pass."""
        all_jobs: list[Job] = []
        while len(self.levels[0]) >= self.cfg.l0_max_ssts:
            jobs, _stage_bytes = self._chain_pass(0, trigger="l0")
            if not jobs:
                break
            all_jobs.extend(jobs)
        return all_jobs

    def _chain_pass(self, level: int, trigger: str
                    ) -> tuple[list[Job], list[int]]:
        """Run ONE compaction pass from ``level`` as a first-class chain and
        ledger its :class:`ChainRecord`."""
        with span("store.chain"):
            cid = self._next_chain_id()
            prev, self._active_chain = self._active_chain, cid
            try:
                jobs, stage_bytes = self._compact_from(level)
            finally:
                self._active_chain = prev
            if jobs:
                head = jobs[-1]
                rec = self.stats.record_chain(ChainRecord(
                    chain_id=cid, trigger=trigger,
                    length=len({j.level for j in jobs}),
                    width=head.l0_consumed or head.n_in_ssts,
                    width_bytes=sum(j.total_bytes for j in jobs),
                    stage_bytes=stage_bytes,
                    n_jobs=len(jobs),
                    job_uids=[j.uid for j in jobs],
                ))
                if self.cfg.paranoid_checks:
                    self._check_chain(jobs, rec)
            return jobs, stage_bytes

    def _check_chain(self, jobs: list[Job], rec: ChainRecord) -> None:
        """Chain invariants at emission time."""
        uids = {j.uid for j in jobs}
        head = jobs[-1]
        assert rec.width >= 1, "chain head must consume at least one SST"
        assert rec.length == len({j.level for j in jobs}), \
            "chain length must match the job topology"
        assert rec.width == (head.l0_consumed or head.n_in_ssts), \
            "chain width must be the head stage's L0 fan-in"
        for j in jobs:
            assert j.chain_id == rec.chain_id, "job missing its chain stamp"
            visited = {j.uid}
            p = j.parent_job
            while p is not None:
                assert p.uid not in visited, "cycle in chain parent lineage"
                assert p.uid in uids, "chain parent crosses chain boundary"
                visited.add(p.uid)
                assert len(visited) <= len(jobs)
                p = p.parent_job

    def _compact_from(self, level: int) -> tuple[list[Job], list[int]]:
        """Compact from ``level`` into ``level+1``, first ensuring space
        below (the dependent chain)."""
        cfg = self.cfg
        jobs: list[Job] = []
        stage_bytes: list[int] = []
        incoming = self.policy.incoming_bytes(self, level)
        if level + 1 < cfg.max_levels - 1:
            while (total_size(self.levels[level + 1]) + incoming
                   > self.policy.level_limit(cfg, level + 1)):
                sub, sub_stage = self._compact_from(level + 1)
                if not sub:
                    break
                jobs.extend(sub)
                stage_bytes.extend(sub_stage)
        deps = [jobs[-1]] if jobs else []
        if level == 0:
            job = self.policy.compact_l0(self, deps)
        else:
            job = self.policy.pick_compaction(self, level, deps)
        if job is not None:
            jobs.append(job)
            stage_bytes.append(job.total_bytes)
        return jobs, stage_bytes

    # --- mechanism primitives (the strategy objects' toolbox) ---------------
    def merge_runs(self, runs: list[tuple[torch.Tensor, torch.Tensor]]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Latest-wins k-way merge on the device, with the merged-key
        accounting every compaction stage charges."""
        with span("store.merge_runs"):
            keys, seqs = merge_backend.merge_runs(runs)
            self.stats.merged_keys += int(keys.shape[0])
            return keys, seqs

    def merge_down(self, level: int, picked_idx: list[int],
                   deps: list[Job]) -> Job | None:
        """Merge the picked SSTs from ``level`` into ``level+1``, grouped
        into contiguous runs, all accounted as ONE chain stage."""
        if not picked_idx:
            return None
        with span("store.merge_down"):
            cfg = self.cfg
            picked_idx = sorted(picked_idx)
            groups: list[list[SST]] = []
            run: list[int] = []
            for i in picked_idx:
                if run and i == run[-1] + 1:
                    run.append(i)
                else:
                    if run:
                        groups.append([self.levels[level][j] for j in run])
                    run = [i]
            groups.append([self.levels[level][j] for j in run])

            read_b = write_b = n_in = n_out = 0
            for group in groups:
                lo = min(s.smallest for s in group)
                hi = max(s.largest for s in group)
                over = self.overlap(level + 1, lo, hi)
                runs = [(s.keys, s.seqs) for s in group]
                runs += [(s.keys, s.seqs) for s in over]
                keys, seqs = self.merge_runs(runs)
                keys, seqs = self.strip_bottom_tombstones(level + 1, keys,
                                                          seqs)
                new = split_fixed(keys, seqs, cfg.kv_size, cfg.sst_size)
                self.replace_in_level(level + 1, over, new)
                guids = {s.uid for s in group}
                self.levels[level] = [s for s in self.levels[level]
                                      if s.uid not in guids]
                self.index.remove_uids(level, sorted(guids))
                read_b += total_size(group) + total_size(over)
                write_b += sum(s.size for s in new)
                n_in += len(group) + len(over)
                n_out += len(new)
            return self.emit_compact_job(level, read_b, write_b, n_in, n_out,
                                         deps)

    def strip_bottom_tombstones(self, target_level: int, keys: torch.Tensor,
                                seqs: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Drop DELETE markers from a merge writing the bottom level."""
        if target_level != self.cfg.max_levels - 1 or keys.shape[0] == 0:
            return keys, seqs
        tomb = (seqs & 1).to(torch.bool)
        nd = int(tomb.sum())
        if nd == 0:
            return keys, seqs
        self.stats.tombstones_dropped += nd
        self.stats.tombstone_bytes_dropped += nd * self.cfg.kv_size
        keep = ~tomb
        return keys[keep], seqs[keep]

    def overlap(self, level: int, lo: int, hi: int) -> list[SST]:
        """SSTs of a sorted, disjoint level intersecting [lo, hi]."""
        start, end = self.index.overlap_slice(level, lo, hi)
        return self.levels[level][start:end]

    def replace_in_level(self, level: int, old: list[SST],
                         new: list[SST]) -> None:
        """Splice ``new`` into the level where ``old`` (a contiguous span,
        possibly empty) sat; keeps the manifest in lock-step."""
        new_live = [s for s in new if s.n > 0]
        lvl = self.levels[level]
        if old:
            old_ids = np.fromiter((s.uid for s in old), np.int64, len(old))
            pos = np.nonzero(np.isin(self.index.uids[level], old_ids))[0]
            start, end = int(pos[0]), int(pos[-1]) + 1
            assert pos.shape[0] == end - start, \
                "replaced SSTs must form a contiguous span"
        elif new_live:
            probe = torch.tensor([new_live[0].smallest], dtype=torch.int64,
                                 device=self.compute_device)
            fences = self.index.dev_smallest[level]
            start = end = int(fence_rank(fences, probe, "left")[0]) \
                if fences.shape[0] else 0
        else:
            return
        self.levels[level] = lvl[:start] + new_live + lvl[end:]
        self.index.splice(level, start, end, new_live)

    def emit_compact_job(self, level: int, read_b: int, write_b: int,
                         n_in: int, n_out: int, deps: list[Job]) -> Job:
        self.stats.compact_bytes_read += read_b
        self.stats.compact_bytes_written += write_b
        self.stats.ssts_created += n_out
        self.stats.manifest_flushes += 1
        self.stats.note_compaction(level, read_b + write_b)
        job = Job("compact", level, read_b, write_b, n_in, n_out, deps=deps,
                  uid=self._next_job_uid(),
                  chain_id=self._active_chain,
                  parent_job=deps[0] if deps else None, shard=self.shard_id)
        self.pending_jobs.append(job)
        return job

    def background_triggers(self) -> list[Job]:
        """Soft over-target compactions (the policy sets the soft factor)."""
        with span("store.triggers"), uid_allocator(self._sst_uids):
            return self._background_triggers()

    def _background_triggers(self) -> list[Job]:
        jobs: list[Job] = []
        cfg = self.cfg
        soft = self.policy.soft_limit_factor
        for level in range(1, cfg.max_levels - 1):
            guard = 0
            while (total_size(self.levels[level])
                   > soft * self.policy.level_target(cfg, level)
                   and guard < 64):
                sub, _sb = self._chain_pass(level, trigger="background")
                if not sub:
                    break
                jobs.extend(sub)
                guard += 1
        return jobs

    def drain_jobs(self) -> list[Job]:
        if self.cfg.paranoid_checks and self.pending_jobs:
            self.check_invariants()
        out, self.pending_jobs = self.pending_jobs, []
        return out

    # ------------------------------------------------------------- lookup
    def get(self, key: int) -> tuple[int | None, int, int]:
        """Point lookup.  Returns (seq|None, device_block_reads, ssts_probed)."""
        seqs, reads, probed = self.get_batch(np.asarray([key], np.int64))
        s = int(seqs[0])
        return (None if s < 0 else s), int(reads[0]), int(probed[0])

    def get_batch(self, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized point lookups: ``(seqs, block_reads, ssts_probed)``;
        misses *and deleted keys* report seq ``-1``."""
        res = self.apply_batch(RequestBatch.gets(keys))
        return res.seqs, res.reads, res.probed

    def _lookup_batch(self, keys: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Resolve a GET batch on the device: memtables (free), L0 newest to
        oldest (every range-overlapping SST), then one fence-selected SST
        per level; a bloom filter screens block reads with deterministic
        false positives.  On the card one fused probe launch walks every
        key through :meth:`probe_runs` (one copy in, one copy out); on the
        CPU the same walk is the plain chain of torch ops."""
        n = int(keys.shape[0])
        if n == 0:
            return (np.full(0, -1, np.int64), np.zeros(0, np.int32),
                    np.zeros(0, np.int32))
        with span("store.lookup"):
            out = lookup_probe(keys, self.probe_runs(), self.cfg.bloom_fpr,
                               self.compute_device).cpu().numpy()
            return out[0], out[1].astype(np.int32), out[2].astype(np.int32)

    def probe_runs(self) -> list[ProbeRun]:
        """The runs a GET walks, in its order, from what the host knows:
        the memtables newest first (their sorted views), L0 newest to
        oldest, then every non-empty level as its flat keys with its fence
        and bloom-seed arrays.  A sorted, disjoint level's concatenated keys
        are globally sorted, so ONE rank over the flat level finds the key
        in the fence-selected SST."""
        runs = []
        for mt in [self.memtable] + self.immutables[::-1]:
            if mt.n:
                keys, seqs = mt.to_sorted()
                if keys.shape[0]:   # not when every write was left out
                    runs.append(ProbeRun(MEMTABLE, keys, seqs))
        for sst in reversed(self.levels[0]):
            runs.append(ProbeRun(L0_SST, sst.keys, sst.seqs, sst.smallest,
                                 sst.largest, bloom_seed_for_uid(sst.uid)))
        for level in range(1, self.cfg.max_levels):
            if self.index.n_ssts(level):
                runs.append(ProbeRun(LEVEL, *self._flat_level(level),
                                     *self.index.fences(level),
                                     self.index.bloom[level]))
        return runs

    def _flat_level(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The level's keys/seqs as one sorted flat device pair, cached
        against the LevelIndex mutation counter."""
        ver = self.index.version[level]
        ent = self._flat.get(level)
        if ent is None or ent[0] != ver:
            lvl = self.levels[level]
            if lvl:
                fkeys = torch.cat([s.keys for s in lvl])
                fseqs = torch.cat([s.seqs for s in lvl])
            else:
                fkeys = torch.empty(0, dtype=torch.int64,
                                    device=self.compute_device)
                fseqs = fkeys.clone()
            ent = (ver, fkeys, fseqs)
            self._flat[level] = ent
        return ent[1], ent[2]

    # --------------------------------------------------------------- scan
    def scan_batch(self, start_keys: np.ndarray,
                   lengths: np.ndarray) -> ResultBatch:
        """Vectorized forward range scans — thin wrapper over
        :meth:`apply_batch`."""
        return self.apply_batch(RequestBatch.scans(start_keys, lengths))

    def _scan_impl(self, start_keys: np.ndarray, lengths: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
        """Resolve a batch of scans: ``(counts, blocks, files, keys, seqs)``.

        Per level, ONE :meth:`LevelIndex.scan_spans` query resolves every
        pending scan's SST span; each scan then k-way merges its per-source
        runs with latest-wins dedup, drops tombstones, and keeps the first
        ``lengths[i]`` live keys.  The per-run entry cap ``m`` doubles until
        the window is proven complete (see the reference's docstring for
        the frontier proof and the merging-iterator cost model).
        """
        cfg = self.cfg
        kv = cfg.kv_size
        n = int(start_keys.shape[0])
        start_keys = np.ascontiguousarray(start_keys, np.int64)
        want = np.asarray(lengths, np.int64)
        counts = np.zeros(n, np.int64)
        blocks = np.zeros(n, np.int32)
        files = np.zeros(n, np.int32)
        out_k: list = [np.empty(0, np.int64)] * n
        out_s: list = [np.empty(0, np.int64)] * n
        if n == 0:
            return counts, blocks, files, np.empty(0, np.int64), \
                np.empty(0, np.int64)
        pending = np.arange(n)
        m = np.maximum(want, 1).copy()
        max_sst = cfg.s_M + cfg.s_m + kv
        while pending.size:
            spans = {}
            for level in range(1, cfg.max_levels):
                if self.index.n_ssts(level):
                    spans[level] = self.index.scan_spans(
                        level, start_keys[pending], m[pending] * kv + max_sst)
            # every pending scan's start key on the device in one copy
            probes = torch.from_numpy(start_keys[pending]).to(
                self.compute_device)
            still = []
            for j, op in enumerate(pending):
                op = int(op)
                op_spans = {lvl: (int(s[j]), int(e[j]))
                            for lvl, (s, e) in spans.items()}
                done = self._scan_one(op, int(start_keys[op]), int(want[op]),
                                      int(m[op]), op_spans, probes[j:j + 1],
                                      counts, blocks, files, out_k, out_s)
                if not done:
                    still.append(op)
            pending = np.asarray(still, np.int64)
            m[pending] *= 2
        flat_k = np.concatenate(out_k)
        flat_s = np.concatenate(out_s)
        return counts, blocks, files, flat_k, flat_s

    def _scan_one(self, op: int, k: int, want: int, m: int,
                  spans: dict[int, tuple[int, int]], probe: torch.Tensor,
                  counts, blocks, files, out_k: list, out_s: list) -> bool:
        """One gather/merge round for scan ``op`` at run cap ``m``; returns
        False when the cap must double (window not yet provably complete).

        ``probe`` holds ``k`` on the compute device.  The scan waits on the
        card three times: for the ranks of ``k`` in every source (one
        overlap_scan launch per source, read back together); for the
        merged window (the merge_path launches of ``merge_runs``) and the
        last entry of each capped run, in one copy, on which the host
        makes the frontier test and the window cut; and for the ranks of
        the window's last key in every device run (one overlap_scan launch
        per run, read back together), which feed the iterator cost
        model."""
        cfg = self.cfg
        kv = cfg.kv_size
        bsz = cfg.block_size
        mts = [mt.to_sorted() for mt in [self.memtable] + self.immutables]
        l0 = [sst for sst in self.levels[0] if sst.largest >= k]
        heads = [(level, start, end) for level, (start, end) in spans.items()
                 if start < end]
        sources = [ks for ks, _ in mts] + [sst.keys for sst in l0] + \
            [self.levels[level][start].keys for level, start, _ in heads]
        pos = torch.cat([fence_rank(keys, probe, "left")
                         for keys in sources]).tolist() if sources else []
        runs: list[tuple[torch.Tensor, torch.Tensor]] = []
        # capped runs whose last entry bounds the window: (run, or None
        # for an unconditional frontier, else the source's largest key)
        capped: list[tuple[int, int | None]] = []
        # device runs for the iterator cost model: (run, SST part bounds)
        dev_runs: list[tuple[int, list[int]]] = []
        for (ks, ss), i in zip(mts, pos):
            if ks.shape[0] - i > m:
                capped.append((len(runs), None))
            if ks.shape[0] > i:
                runs.append((ks[i:i + m], ss[i:i + m]))
        pos = pos[len(mts):]
        for sst, i in zip(l0, pos):
            if sst.n == i:
                continue
            if sst.n - i >= m:
                capped.append((len(runs), sst.largest))
            dev_runs.append((len(runs), [min(m, sst.n - i)]))
            runs.append((sst.keys[i:i + m], sst.seqs[i:i + m]))
        pos = pos[len(l0):]
        for (level, start, end), i in zip(heads, pos):
            remaining = m
            parts_k: list[torch.Tensor] = []
            parts_s: list[torch.Tensor] = []
            for p in range(start, end):
                if remaining <= 0:
                    break
                sst = self.levels[level][p]
                a = i if p == start else 0
                b = min(sst.n, a + remaining)
                if b <= a:
                    continue
                parts_k.append(sst.keys[a:b])
                parts_s.append(sst.seqs[a:b])
                remaining -= b - a
            if parts_k:
                if remaining == 0:
                    capped.append((len(runs),
                                   int(self.index.largest[level][-1])))
                bounds = np.cumsum([q.shape[0] for q in parts_k]).tolist()
                dev_runs.append((len(runs), bounds))
                runs.append((torch.cat(parts_k), torch.cat(parts_s))
                            if len(parts_k) > 1 else (parts_k[0], parts_s[0]))
        if not runs:
            return True          # nothing at or past k anywhere
        keys_d, seqs_d = merge_backend.merge_runs(runs)
        n = keys_d.shape[0]
        host = torch.cat([keys_d, seqs_d] + [runs[r][0][-1:] for r, _ in
                                             capped]).cpu().numpy()
        keys, seqs = host[:n], host[n:2 * n]
        log, tomb = seqs >> 1, (seqs & 1).astype(bool)
        live_idx = np.nonzero(~tomb)[0]
        frontiers = [int(last) for (_, largest), last in
                     zip(capped, host[2 * n:])
                     if largest is None or largest > int(last)]
        if frontiers:
            frontier = min(frontiers)
            trusted = live_idx[keys[live_idx] <= frontier]
            if trusted.shape[0] < want:
                return False     # double m: window not provably complete
        take = live_idx[:want]
        consumed = [0] * len(dev_runs)
        if take.shape[0] and dev_runs:
            j = int(take[-1])
            consumed = torch.cat([fence_rank(runs[r][0], keys_d[j:j + 1],
                                             "right")
                                  for r, _ in dev_runs]).tolist()
        n_blocks = n_files = 0
        for (_, bounds), used in zip(dev_runs, consumed):
            if used == 0:
                n_files += 1     # seek only: position at the first entry
                n_blocks += 1
                continue
            prev = 0
            for b in bounds:
                part = min(used, b) - prev
                if part <= 0:
                    break
                n_files += 1
                n_blocks += -(-part * kv // bsz)
                prev = b
        out_k[op] = keys[take]
        out_s[op] = log[take]
        counts[op] = int(take.shape[0])
        blocks[op] = n_blocks
        files[op] = n_files
        return True

    # -------------------------------------------------------------- misc
    def level_sizes(self) -> list[int]:
        return [total_size(lvl) for lvl in self.levels]

    def total_keys(self) -> int:
        n = self.memtable.n + sum(m.n for m in self.immutables)
        return n + sum(s.n for lvl in self.levels for s in lvl)

    def check_invariants(self) -> None:
        """Mechanism invariants (index mirroring, SST sortedness, level
        disjointness) plus the strategy object's policy-specific ones."""
        from .sst import level_check_disjoint
        self.index.check_against(self.levels)
        for sst in self.levels[0]:
            sst.check_invariants()
        for level in range(1, self.cfg.max_levels):
            for sst in self.levels[level]:
                sst.check_invariants()
            level_check_disjoint(self.levels[level])
        self.policy.check_invariants(self)

    def merged_view(self) -> dict[int, int]:
        """Ground-truth *live* key -> latest logical seq, for tests."""
        view: dict[int, int] = {}

        def fold(keys: torch.Tensor, seqs: torch.Tensor) -> None:
            for key, s in zip(keys.tolist(), seqs.tolist()):
                prev = view.get(key)
                if prev is None or s > prev:
                    view[key] = s

        for level in range(self.cfg.max_levels - 1, 0, -1):
            for sst in self.levels[level]:
                fold(sst.keys, sst.seqs)
        for sst in self.levels[0]:
            fold(sst.keys, sst.seqs)
        for mt in self.immutables + [self.memtable]:
            fold(*mt.to_sorted())
        return {key: s >> 1 for key, s in view.items() if not (s & 1)}
