"""Faults planted under the timed path, each of which the comparison
that decides ``correct`` must catch: ``port_bench/tests`` plants them at
a tiny size on the CPU, ``port_bench.limits --fault`` at a cell's own
size on the card.  Each is a context manager that patches the program
and restores it on exit.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def state_unchanged():
    """A write is acknowledged and leaves the store as it was."""
    from repro_torch.core.memtable import Memtable

    def put_batch(self, keys, seqs):
        self._n += int(keys.shape[0])
        self._sorted = None
    with _patched(Memtable, "put_batch", put_batch):
        yield


@contextlib.contextmanager
def half_left_out():
    """Half of each written batch is left out, the rest kept."""
    from repro_torch.core.memtable import Memtable
    orig = Memtable.put_batch

    def put_batch(self, keys, seqs):
        half = keys.shape[0] // 2
        orig(self, keys[:half], seqs[:half])
        self._n += int(keys.shape[0]) - half
    with _patched(Memtable, "put_batch", put_batch):
        yield


@contextlib.contextmanager
def answer_altered():
    """One answer of each lookup batch, and the last departure of each
    queue pass, altered where they are produced."""
    from repro_torch.core import lsm, sim
    orig_lookup = lsm.LSMTree._lookup_batch
    orig_lindley = sim.lindley_batch

    def lookup(self, keys):
        seqs, reads, probed = orig_lookup(self, keys)
        seqs = seqs.copy()
        seqs[:1] += 1
        return seqs, reads, probed

    def lindley(service, arrivals, offsets, *a, **k):
        out = orig_lindley(service, arrivals, offsets, *a, **k).clone()
        out[-1:] += 1e-6
        return out
    with _patched(lsm.LSMTree, "_lookup_batch", lookup), \
            _patched(sim, "lindley_batch", lindley):
        yield


@contextlib.contextmanager
def read_dropped():
    """Every GET of a lookup batch reads one block fewer."""
    from repro_torch.core import lsm
    orig = lsm.LSMTree._lookup_batch

    def lookup(self, keys):
        seqs, reads, probed = orig(self, keys)
        return seqs, (reads - 1).clip(min=0).astype(reads.dtype), probed
    with _patched(lsm.LSMTree, "_lookup_batch", lookup):
        yield


@contextlib.contextmanager
def stall_halved():
    """Every write stall the DES charges at a fill is half as long."""
    from repro_torch.core import sim
    orig_l0, orig_wb = sim.Simulator._l0_stall, sim.Simulator._wb_stall

    def l0_stall(self, tree_idx, t):
        stall, cid = orig_l0(self, tree_idx, t)
        return stall / 2, cid

    def wb_stall(self, tree_idx, t):
        return orig_wb(self, tree_idx, t) / 2
    with _patched(sim.Simulator, "_l0_stall", l0_stall), \
            _patched(sim.Simulator, "_wb_stall", wb_stall):
        yield


@contextlib.contextmanager
def compaction_early():
    """Every compaction starts as soon as it is ready, no slot, level or
    chain parent holding it back, and is done in half its modelled time."""
    from repro_torch.core import sim

    def schedule(self, job, ready, duration, region=0):
        job.t_start = ready
        job.t_finish = ready + duration / 2
        job.scheduled = True
    with _patched(sim.ChainScheduler, "schedule", schedule):
        yield


FAULTS = {"state_unchanged": state_unchanged,
          "half_left_out": half_left_out,
          "answer_altered": answer_altered,
          "read_dropped": read_dropped,
          "stall_halved": stall_halved,
          "compaction_early": compaction_early}
#: the entries in whose timed path each fault can lie
ENTRIES = {"state_unchanged": ("replay", "served"),
           "half_left_out": ("replay", "served"),
           "answer_altered": ("replay", "served"),
           "read_dropped": ("replay",),
           "stall_halved": ("replay",),
           "compaction_early": ("replay",)}
