"""The DES schedule sanitizer (``REPRO_SANITIZE=1``): tsan for simulated
time.

The engines' stall-gate pruning (``_l0_stall`` /
``_wb_stall`` dropping entries that "can never gate again") and the
chain ledger's temporal accounting are only correct under scheduling
preconditions the engine never checked at runtime:

* **S401** — per-tree event times are nondecreasing (the global event
  heap dispatches in simulated-time order, so each tree sees a
  monotonic clock — the exact license for dropping cleared L0 entries).
* **S402** — a chain child never starts before its parent finishes
  (``parent_job.t_finish`` is the intra-chain dependency edge).
* **S403** — a ``(tree, level)`` compaction slot is never doubly
  occupied: two jobs reading the same source level of the same tree
  must not overlap in time (``SlotPool.level_free`` exclusivity).
* **S404** — stall-gate queries per tree are issued at nondecreasing
  times (the gates prune history under that assumption).

When ``REPRO_SANITIZE`` is unset this module costs one ``None`` check
per hook site; when set, violations raise
:class:`ScheduleSanitizerError` at the exact first divergence instead
of surfacing later as an unexplainable parity diff.

This module imports nothing of the package: the engines
(:mod:`repro_torch.core.sim`, :mod:`repro_torch.core.fleet`) import *it*.
"""

from __future__ import annotations

import math
import os

ENV_VAR = "REPRO_SANITIZE"

#: slack for float-time comparisons, matching the engine's paranoid checks
EPS = 1e-9


class ScheduleSanitizerError(AssertionError):
    """A DES scheduling invariant was violated (rule S401..S404)."""


class ScheduleSanitizer:
    """Runtime schedule checker, wired into the event heap and the slot
    pools by :class:`repro_torch.core.sim.Simulator` (and the fleet engine,
    which calls :meth:`reset` per temporal pass).

    Hooks:

    * :meth:`on_event` — after each event-heap pop, with the event's
      tree index and simulated time.
    * :meth:`on_gate` — at each ``_l0_stall`` / ``_wb_stall`` query.
    * :meth:`on_schedule` — after a slot pool assigns ``t_start`` /
      ``t_finish`` to a job.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Forget all history (the fleet engine replays many temporal
        passes over one structural phase; each pass is its own
        timeline)."""
        self._event_t: dict[int, float] = {}
        self._gate_t: dict[int, float] = {}
        self._slot_busy_until: dict[tuple[str, int, int], float] = {}
        self.events_checked = 0
        self.jobs_checked = 0

    # ------------------------------------------------------------ hooks
    def on_event(self, tree: int, t: float) -> None:
        """S401: per-tree event times must be nondecreasing."""
        self.events_checked += 1
        last = self._event_t.get(tree, -math.inf)
        if t < last - EPS:
            raise ScheduleSanitizerError(
                f"S401: event time went backwards for tree {tree}: "
                f"{t!r} after {last!r} — the stall-gate pruning "
                f"assumes a monotonic per-tree clock")
        if t > last:
            self._event_t[tree] = t

    def on_gate(self, tree: int, t: float) -> None:
        """S404: stall-gate queries per tree at nondecreasing times."""
        last = self._gate_t.get(tree, -math.inf)
        if t < last - EPS:
            raise ScheduleSanitizerError(
                f"S404: stall gate for tree {tree} queried at {t!r} "
                f"after {last!r} — pruned history would be consulted "
                f"out of order")
        if t > last:
            self._gate_t[tree] = t

    def on_schedule(self, region: int, job) -> None:
        """S402 + S403 for one freshly scheduled job."""
        self.jobs_checked += 1
        parent = getattr(job, "parent_job", None)
        if parent is not None:
            if not parent.scheduled:
                raise ScheduleSanitizerError(
                    f"S402: chain child (chain {job.chain_id}, level "
                    f"{job.level}) scheduled before its parent was "
                    f"scheduled at all")
            if job.t_start < parent.t_finish - EPS:
                raise ScheduleSanitizerError(
                    f"S402: chain child starts at {job.t_start!r} "
                    f"before its parent finishes at "
                    f"{parent.t_finish!r} (chain {job.chain_id})")
        key = (job.kind, region, job.level)
        busy_until = self._slot_busy_until.get(key, -math.inf)
        if job.t_start < busy_until - EPS:
            raise ScheduleSanitizerError(
                f"S403: overlapping occupancy of {job.kind} slot "
                f"(tree {region}, level {job.level}): job starts at "
                f"{job.t_start!r} while the slot is busy until "
                f"{busy_until!r}")
        if job.t_finish > busy_until:
            self._slot_busy_until[key] = job.t_finish


def maybe_sanitizer() -> ScheduleSanitizer | None:
    """A fresh sanitizer when ``REPRO_SANITIZE`` is set (to anything but
    ``0``/empty), else ``None`` — the engine's hook sites cost a single
    ``is not None`` test in the common case."""
    if os.environ.get(ENV_VAR, "0") in ("", "0"):
        return None
    return ScheduleSanitizer()
