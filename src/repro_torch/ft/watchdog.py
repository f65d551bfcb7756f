"""Fault tolerance: step watchdog, failure injection, elastic restart —
the port's own copy of ``repro/ft/watchdog.py`` (no JAX in it).

``StepWatchdog`` tracks an EMA of step wall-times and flags stragglers
(> ``k``× EMA) — at fleet scale the action is to re-claim that rank's
batches through ``data.BatchAllocator`` and/or trigger an elastic remesh.
``FailureInjector`` drives the restart path in tests/examples: the train
loop catches ``InjectedFailure`` and restores from the LSM checkpoint
store onto the same device — see launch/train.py; the elastic remesh is a
restore under the new mesh (``LSMCheckpointStore.restore(mesh=,
specs=)``, ``launch.mesh.make_mesh``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


class InjectedFailure(RuntimeError):
    pass


@dataclass
class StepWatchdog:
    threshold: float = 3.0
    alpha: float = 0.2
    ema: float | None = None
    stragglers: list[tuple[int, float]] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.stragglers.append((step, dt))
        # EMA excludes straggler samples so one hiccup doesn't mask the next
        if not slow:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


@dataclass
class FailureInjector:
    fail_at_step: int | None = None
    fired: bool = False

    def check(self, step: int):
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")
