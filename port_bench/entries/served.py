"""The ``served`` entry: YCSB batches served by the store,
``repro_torch.core.ShardedStore.apply_batch`` over the configuration's
shards, as one closed-loop client.

Set-up loads the population through PUT batches (the state the traffic
needs), makes ``warm_batches + pool_batches`` typed batches of YCSB ops
from the seed, and serves the first ``warm_batches``, which warms every
shape the window uses.  The window serves the other ``pool_batches`` in
turn, each timed alone from the call to the synchronize after it, and
starts over at the first of them when it has served them all (the
traffic file says how often a window does); memtables roll inline, flush
and compaction included, inside the batch that fills them.
The program's default switches apply: ``REPRO_PARANOID_CHECKS`` and
``REPRO_SANITIZE`` are not set.

What is compared after the window (``check``), against
``reference.store``: every answer of every batch served (each PUT's
acknowledged seqno, each GET's seqno or miss), and every key of the
population read back from the store.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import generators, harness
from ..reference import store as store_ref

READBACK_CHUNK = 1 << 20
TRACED_S = 2.0      # longest stretch under the device trace


class Entry:
    name = "served"

    def __init__(self, spec: dict, traffic: dict, seed: int,
                 compute_device: str = "cuda", scale: int | None = None):
        import torch
        from repro_torch.core import RequestBatch, ShardedStore
        t0 = time.perf_counter()
        self.compute_device = compute_device
        self.cfg = harness.lsm_config(spec, scale)
        self.pop = generators.unique_sorted(
            generators.load_keys(traffic["n_load"], seed))
        n = self.pop.shape[0]
        warm = traffic["warm_batches"]
        pool = warm + traffic["pool_batches"]
        size = traffic["batch_ops"]
        kinds, idx = generators.mixed_index(n, pool * size,
                                            traffic["read_frac"], seed + 1000,
                                            traffic["theta"])
        self.pool_kinds = kinds.reshape(pool, size)
        self.pool_idx = idx.reshape(pool, size)
        keys = self.pop[idx].reshape(pool, size)
        self.batches = [RequestBatch(self.pool_kinds[p], keys[p])
                        for p in range(pool)]
        self.warm = warm
        t1 = time.perf_counter()
        self.store = ShardedStore(self.cfg, compute_device=compute_device)
        step = traffic["load_batch"]
        for a in range(0, n, step):
            self.store.apply_batch(RequestBatch.puts(self.pop[a:a + step]))
        self.served: list[int] = []        # index of each batch served
        self.answers: list[np.ndarray] = []
        self._sync = torch.cuda.synchronize if compute_device == "cuda" \
            else (lambda: None)
        t2 = time.perf_counter()
        self._serve(warm)
        self._sync()
        self.setup_parts = {"traffic_s": t1 - t0, "preload_s": t2 - t1,
                            "warm_batches_s": time.perf_counter() - t2}

    # ---------------------------------------------------------- the work
    def _serve(self, count: int | None, seconds: float | None = None):
        """Serve batches in turn, ``count`` of them or until ``seconds``
        have passed: (wall of each batch, whether it rolled a memtable,
        wall of all)."""
        walls, rolled = [], []
        apply, log, sync = self.store.apply_batch, self.store.job_log, \
            self._sync
        warm, pool = self.warm, len(self.batches) - self.warm
        t_start = time.perf_counter()
        while True:
            n = len(self.served)
            p = n if n < warm else warm + (n - warm) % pool
            jobs = len(log)
            t0 = time.perf_counter()
            res = apply(self.batches[p])
            sync()
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            rolled.append(len(log) > jobs)
            self.served.append(p)
            self.answers.append(res.seqs)
            if count is not None and len(walls) >= count:
                break
            if seconds is not None and t1 - t_start >= seconds:
                break
        return np.array(walls), np.array(rolled, bool), \
            time.perf_counter() - t_start

    def window(self, seconds: float) -> dict:
        walls, _rolled, wall = self._serve(None, seconds)
        ops = walls.shape[0] * self.batches[0].kinds.shape[0]
        self.attempted = ops
        return {"store_ops_per_s": (ops / wall, "ops/s"),
                "batches": walls.shape[0],
                "rolled": int(_rolled.sum()),
                "pool_cycled": walls.shape[0] > len(self.batches) - self.warm}

    def traced(self, seconds: float) -> dict:
        """Half the window plain, for the batches' walls, then at most
        half the window (and at most ``TRACED_S``) under the device trace;
        the program's launch counters over both."""
        art: dict = {"entry": self.name}
        size = self.batches[0].kinds.shape[0]
        before = harness.launches()
        walls, rolled, _wall = self._serve(None, seconds / 2)
        art["batch_walls_s"] = walls
        art["batch_rolled"] = rolled
        art["batches"] = walls.shape[0]
        with harness.device_trace(art, self.compute_device == "cuda"):
            more, _r, _w = self._serve(None, min(seconds / 2, TRACED_S))
        art["launches"] = harness.launch_delta(before, harness.launches())
        art["ops"] = (walls.shape[0] + more.shape[0]) * size
        self.attempted = art["ops"]
        return art

    # -------------------------------------------------------- the check
    def collect(self) -> None:
        """Read every key of the population back through the store, then
        free the program's state."""
        from repro_torch.core import RequestBatch
        got = np.empty(self.pop.shape[0], np.int64)
        for a in range(0, self.pop.shape[0], READBACK_CHUNK):
            b = min(a + READBACK_CHUNK, self.pop.shape[0])
            got[a:b] = self.store.apply_batch(
                RequestBatch.gets(self.pop[a:b])).seqs
        self.readback = got
        self.store = None
        gc.collect()

    def check(self, control: bool = False
              ) -> list[tuple[str, float, float]]:
        """(name, number, limit) of every comparison.  ``control`` puts
        the reference in the program's place with one guarantee broken:
        its reads are taken before the batch's writes land."""
        ref = store_ref.LatestSeq(self.pop.shape[0])
        ref.load(np.arange(self.pop.shape[0]))
        ctl = None
        if control:
            ctl = store_ref.LatestSeq(self.pop.shape[0])
            ctl.load(np.arange(self.pop.shape[0]))
        wrong = 0
        for p, got in zip(self.served, self.answers):
            want = ref.batch(self.pool_kinds[p], self.pool_idx[p])
            if ctl is not None:
                got = ctl.batch(self.pool_kinds[p], self.pool_idx[p],
                                reads_first=True)
            wrong += store_ref.mismatches(got, want)
        back = ctl.latest if ctl is not None else self.readback
        readback = store_ref.mismatches(back, ref.latest)
        self.failed = wrong + readback
        return [("answers_wrong", wrong, 0), ("readback_wrong", readback, 0)]
