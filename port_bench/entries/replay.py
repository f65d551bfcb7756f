"""The ``replay`` entry: YCSB replayed through the DES,
``repro_torch.core.Simulator.run``.

Set-up makes the trace from the seed and runs one replay, which builds and
warms every kernel and shape the window uses.  The window runs whole
replays back to back, each a fresh ``Simulator`` over the same trace with
the configuration's policy at its byte scale and ``DeviceModel.scaled``, as
a policy researcher runs one, and reads ops of all completed replays over
their wall time.  Nothing the window times is generated inside it.

What is compared after the window (``check``), against ``reference``:
for three replays of the run drawn from the seed (every replay is the
same work over the same trace), every flush's and compaction's start
and finish and every op's simulated latency, worked out again from
the op stream, the device model and the ledger's structure; every GET's
block reads against what its key's place implies; and every acknowledged
write of the last replay read back from its store.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import generators, harness
from ..reference import des as des_ref
from ..reference import store as store_ref

# Limits, each between the readings it was set from (PERF.md, section 2):
# the widest gap of a simulated latency and of a job's start or finish
# from the reference's, in seconds (a stall that differs moves both);
# GETs whose reads break the lookup's rule, and writes read back wrong
# (exact).
LATENCY_GAP_S = 1e-7
JOB_GAP_S = 1e-9
READBACK_CHUNK = 1 << 20
CHECKED = 3         # replays of a run that the check compares
TRACED_S = 6.0      # longest stretch under the device trace


class Entry:
    name = "replay"

    def __init__(self, spec: dict, traffic: dict, seed: int,
                 compute_device: str = "cuda", scale: int | None = None):
        t0 = time.perf_counter()
        self.compute_device = compute_device
        self.cfg = harness.lsm_config(spec, scale)
        self.dev = harness.device_model(spec)
        self.device_dict = spec["device_model"]
        self.spec = spec
        self.seed = seed
        self.ops, self.keys, self.arrivals, self.n_loaded, self.key_idx = \
            generators.ycsb_trace_index(
                traffic["n_load"], traffic["run_ops"], seed,
                read_frac=traffic["read_frac"], theta=traffic["theta"],
                run_seed=seed + 1000,
                load_rate=traffic["load_rate"], settle_s=traffic["settle_s"],
                run_rate=traffic["run_rate"])
        self.pop = self.keys[:self.n_loaded]        # sorted, unique
        self.n_ops = int(self.ops.shape[0])
        self.runs: list[dict] = []    # what the check reads of each replay
        self.last = None              # the last replay's Simulator
        t1 = time.perf_counter()
        self._replay()                # builds, compiles and warms
        self.runs.clear()
        self.setup_parts = {"trace_s": t1 - t0,
                            "warm_replay_s": time.perf_counter() - t1}

    # ---------------------------------------------------------- the work
    def _replay(self):
        import torch
        from repro_torch.core import Simulator, UidNamespace
        with harness.span("port_bench.free_last_replay"):
            self.last = None
        with harness.span("port_bench.new_simulator"):
            sim = Simulator(self.cfg, self.dev, uids=UidNamespace(),
                            compute_device=self.compute_device)
        with harness.span("port_bench.simulator_run"):
            res = sim.run(self.ops, self.keys, self.arrivals)
            if self.compute_device == "cuda":
                torch.cuda.synchronize()
        self.runs.append(_judged(res))
        self.last = sim

    def _replays_for(self, seconds: float) -> tuple[int, float]:
        """Whole replays until ``seconds`` have passed: (count, wall)."""
        t0 = time.perf_counter()
        n = 0
        while True:
            self._replay()
            n += 1
            wall = time.perf_counter() - t0
            if wall >= seconds:
                return n, wall

    def window(self, seconds: float) -> dict:
        n, wall = self._replays_for(seconds)
        self.attempted = n * self.n_ops
        last = self.runs[-1]
        return {"replay_ops_per_s": (n * self.n_ops / wall, "ops/s"),
                "replays": n, "jobs": int(last["ledger"]["flush"].shape[0]),
                "stalls": last["stalls"]}

    def traced(self, seconds: float) -> dict:
        """Whole replays for half the window (at most ``TRACED_S``) under
        the device trace, then one replay under the host profile; the
        program's launch counters over both."""
        art: dict = {"entry": self.name, "kv_size": self.cfg.kv_size}
        before = harness.launches()
        with harness.device_trace(art, self.compute_device == "cuda"):
            n, _wall = self._replays_for(min(seconds / 2, TRACED_S))
        traced = self.runs[-n:]
        art["traced_replays"] = n
        art["ops_traced"] = n * self.n_ops
        art["compaction_bytes"] = (
            sum(float(r["ledger"]["bytes_read"][~r["ledger"]["flush"]].sum())
                for r in traced),
            sum(float(r["ledger"]["bytes_written"][
                ~r["ledger"]["flush"]].sum()) for r in traced))
        art["merged_keys"] = sum(r["merged_keys"] for r in traced)
        with harness.host_profile(art):
            self._replay()
        art["launches"] = harness.launch_delta(before, harness.launches())
        art["ops"] = (n + 1) * self.n_ops
        self.attempted = (n + 1) * self.n_ops
        return art

    # -------------------------------------------------------- the check
    def collect(self) -> None:
        """Read every key of the population back through the last
        replay's store, then free the program's state."""
        from repro_torch.core import RequestBatch
        tree = self.last.trees[0]
        got = np.empty(self.pop.shape[0], np.int64)
        for a in range(0, self.pop.shape[0], READBACK_CHUNK):
            b = min(a + READBACK_CHUNK, self.pop.shape[0])
            got[a:b] = tree.apply_batch(RequestBatch.gets(self.pop[a:b])).seqs
        self.readback = got
        self.last = None
        gc.collect()

    def _sample(self) -> list[dict]:
        """The replays that the check compares: ``CHECKED`` of the run's
        replays, drawn from the seed (all when there are no more)."""
        n = len(self.runs)
        if n <= CHECKED:
            return self.runs
        pick = np.random.default_rng(self.seed).choice(n, CHECKED,
                                                      replace=False)
        return [self.runs[i] for i in sorted(pick)]

    def check(self, control: bool = False
              ) -> list[tuple[str, float, float]]:
        """(name, number, limit) of every comparison.  ``control`` puts
        the reference in the program's place, computed in float32, the
        precision below the DES's float64."""
        key_idx = self.key_idx
        latest = store_ref.latest_of_trace(self.ops, key_idx,
                                           self.pop.shape[0])
        fills = des_ref.fill_ops(self.ops, self.cfg.keys_per_memtable)
        in_mem = des_ref.memtable_hits(self.ops, key_idx, fills)
        lsm = self.spec["lsm"]
        worst = {"latency": 0.0, "job": 0.0}
        reads_wrong = 0
        self.failed = 0
        for run in self._sample():
            reads_wrong += des_ref.read_faults(
                self.ops, in_mem, run["get_reads"], run["get_probed"])
            args = (self.ops, self.arrivals, run["get_reads"], fills,
                    run["ledger"], lsm, self.device_dict,
                    self.spec["policy"])
            want = des_ref.timeline(*args)
            got = des_ref.timeline(*args, dtype=np.float32) if control \
                else {"latency": run["latency"],
                      "start": run["ledger"]["t_start"],
                      "finish": run["ledger"]["t_finish"]}
            gaps = {
                "latency": np.abs(got["latency"] - want["latency"]),
                "job": np.maximum(np.abs(got["start"] - want["start"]),
                                  np.abs(got["finish"] - want["finish"]))}
            for name, limit in (("latency", LATENCY_GAP_S),
                                ("job", JOB_GAP_S)):
                g = gaps[name]
                if g.size:
                    worst[name] = max(worst[name], float(g.max()))
                self.failed += int(np.count_nonzero(~(g <= limit)))
        wrong = store_ref.mismatches(self.readback, latest)
        self.failed += wrong + reads_wrong
        return [("latency_gap_s", worst["latency"], LATENCY_GAP_S),
                ("job_time_gap_s", worst["job"], JOB_GAP_S),
                ("reads_wrong", reads_wrong, 0),
                ("readback_wrong", wrong, 0)]


def _judged(res) -> dict:
    """What the check and the traced metrics read of one replay's result,
    as NumPy arrays (no objects of the program kept): per op its latency,
    block reads and SSTs probed; the count of stalls; and the ledger of
    jobs in emission order, with the structure that the reference
    schedules from and the times that it judges."""
    every = res.job_log
    at = {j.uid: i for i, j in enumerate(every)}
    chains = res.stats.chain_index
    deps = []
    for j in every:
        assert len(j.deps) <= 1, "a job with more than one dependency"
        deps.append(at[j.deps[0].uid] if j.deps else -1)
    flush = np.array([j.kind == "flush" for j in every], bool)
    return {
        "merged_keys": res.stats.merged_keys,
        "latency": np.asarray(res.latency, np.float64),
        "get_reads": np.asarray(res.get_reads),
        "get_probed": np.asarray(res.get_probed),
        "stalls": len(res.stall_events),
        "ledger": {
            "flush": flush,
            "l0_chain": np.array(
                [j.kind == "compact" and chains[j.chain_id].trigger == "l0"
                 for j in every], bool),
            "chain_id": np.array([j.chain_id for j in every], np.int64),
            "level": np.array([j.level for j in every], np.int64),
            "dep": np.array(deps, np.int64),
            "l0_consumed": np.array([j.l0_consumed for j in every],
                                    np.int64),
            "bytes_read": np.array([j.bytes_read for j in every],
                                   np.float64),
            "bytes_written": np.array([j.bytes_written for j in every],
                                      np.float64),
            "n_in": np.array([j.n_in_ssts for j in every], np.int64),
            "n_out": np.array([j.n_out_ssts for j in every], np.int64),
            "t_start": np.array([j.t_start for j in every], np.float64),
            "t_finish": np.array([j.t_finish for j in every], np.float64),
        },
    }
