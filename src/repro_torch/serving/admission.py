"""Admission control in front of the per-shard foreground queues.

The controller is a *deterministic pre-pass* over the offered op stream:
per-tenant token buckets (a pure function of arrival times), a per-shard
queue-delay estimator (a Lindley recursion over nominal per-kind service
estimates, advanced only by admitted ops), and a leaky-bucket L0
write-pressure model (admitted write bytes fill estimated memtables;
estimated L0 SSTs drain at a rate derived from the device and the
config's growth factor).  Every offered op gets exactly one verdict —
ADMIT, THROTTLE (token bucket empty) or SHED (priority-aware overload
protection) — so ``shed + throttled + admitted == offered`` by
construction, and the serving layer re-asserts it at runtime under
``cfg.paranoid_checks``.

The pre-pass is host-side control: a sequential loop over the offered
ops (each verdict depends on the buckets and estimators the earlier ones
left), in the reference's arithmetic; preload ops are skipped without a
visit.

Design note: shedding off *live* engine state (actual queue delay, actual
L0 depth) would make the admitted stream a function of simulated timing,
which breaks the fleet engine's arrival-independent structural replay and
with it the serial==fleet parity gate.  The estimator trades exactness
for that property: both engines receive the *same* admitted stream, so
open-loop parity is inherited from the existing engine parity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.sim import GET_CPU, PUT_SERVICE, SCAN_CPU
from ..core.types import DeviceModel, LSMConfig, OpKind

# verdict codes (uint8): one per offered op, never silently dropped
ADMIT = 0
THROTTLE = 1
SHED = 2


class TokenBucket:
    """Classic token bucket over *simulated* arrival times.

    Capacity ``burst_ops`` tokens, refilled continuously at
    ``rate_ops_s``; an op is admitted iff a whole token is available at
    its arrival instant.  Over any window ``[t1, t2]`` the bucket admits
    at most ``burst_ops + rate_ops_s * (t2 - t1)`` ops — the property the
    traffic tests pin.  ``rate_ops_s <= 0`` disables the limit.
    """

    __slots__ = ("rate_ops_s", "burst_ops", "tokens", "t_last_s")

    def __init__(self, rate_ops_s: float, burst_ops: float = 64.0):
        self.rate_ops_s = float(rate_ops_s)
        self.burst_ops = float(max(1.0, burst_ops))
        self.tokens = self.burst_ops
        self.t_last_s = 0.0

    def try_admit(self, t_s: float) -> bool:
        """Refill to ``t_s`` and consume one token if available."""
        if self.rate_ops_s <= 0.0:
            return True
        if t_s > self.t_last_s:
            self.tokens = min(self.burst_ops,
                              self.tokens
                              + (t_s - self.t_last_s) * self.rate_ops_s)
            self.t_last_s = t_s
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass(frozen=True)
class AdmissionConfig:
    """Knobs of the admission pre-pass (see module docstring).

    ``max_queue_delay_s`` is the shed threshold for priority
    ``shed_priority_floor``; each further priority level divides it by
    ``priority_factor`` (lower priority ⇒ shed earlier).  Priorities
    *below* the floor (0 = highest) are never shed — only throttled by
    their own token bucket, if any.
    """

    max_queue_delay_s: float = 0.10     # shed threshold at the floor priority
    priority_factor: float = 4.0        # threshold divisor per priority level
    shed_priority_floor: int = 1        # priorities < floor are never shed
    l0_shed_depth: float = 6.0          # estimated L0 SSTs that shed writes
    l0_drain_factor: float = 4.0        # est. L0 drain time, in sst-I/O units
    nominal_get_blocks: float = 2.0     # controller's GET device-read model
    nominal_scan_blocks: float = 8.0    # controller's SCAN device-read model


def nominal_service_s(op_types: np.ndarray, acfg: AdmissionConfig,
                      device: DeviceModel) -> np.ndarray:
    """Controller-side per-op service estimate (seconds).

    Deliberately the *nominal* cost — CPU plus the modeled device reads —
    with no busy inflation or stall feedback: it only has to rank load
    against capacity, not reproduce the DES.
    """
    block_read_s = device.read_time(device.block_size)
    per_kind = np.zeros(4, np.float64)
    per_kind[int(OpKind.PUT)] = PUT_SERVICE
    per_kind[int(OpKind.DELETE)] = PUT_SERVICE
    per_kind[int(OpKind.GET)] = GET_CPU + acfg.nominal_get_blocks * block_read_s
    per_kind[int(OpKind.SCAN)] = (SCAN_CPU
                                  + acfg.nominal_scan_blocks * block_read_s)
    return per_kind[op_types]


def admit(op_types: np.ndarray, arrivals: np.ndarray,
          tenant_ids: np.ndarray, shard_ids: np.ndarray,
          tenants, acfg: AdmissionConfig, cfg: LSMConfig,
          device: DeviceModel) -> np.ndarray:
    """One verdict per op (ADMIT / THROTTLE / SHED), arrival order.

    Ops with ``tenant_ids < 0`` (store preload) bypass admission and do
    not advance the estimators: they model the store's population, not
    offered traffic.  ``tenants`` is the spec sequence indexed by
    ``tenant_ids`` (needs ``priority`` / ``limit_ops_s`` / ``burst_ops``).
    """
    n = int(arrivals.shape[0])
    verdicts = np.zeros(n, np.uint8)
    offered = np.nonzero(np.asarray(tenant_ids) >= 0)[0]
    svc = nominal_service_s(op_types, acfg, device)
    is_write = (op_types == OpKind.PUT) | (op_types == OpKind.DELETE)
    buckets = [TokenBucket(t.limit_ops_s or 0.0, t.burst_ops)
               for t in tenants]
    sheddable = [t.priority >= acfg.shed_priority_floor for t in tenants]
    threshold_s = [acfg.max_queue_delay_s
                   / acfg.priority_factor
                   ** max(0, t.priority - acfg.shed_priority_floor)
                   for t in tenants]
    # estimated L0 drain: one relief compaction touches the sst plus the
    # overlap the growth factor implies — l0_drain_factor sst-I/O units
    sst_io_s = (device.read_time(cfg.sst_size)
                + device.write_time(cfg.sst_size))
    l0_drain_s = acfg.l0_drain_factor * sst_io_s
    n_shards = max(1, cfg.n_shards)
    depart_est_s = [0.0] * n_shards      # Lindley clock per shard queue
    l0_est = [0.0] * n_shards            # estimated L0 SSTs (leaky)
    l0_t_s = [0.0] * n_shards
    fill_bytes = [0.0] * n_shards        # admitted write bytes mod memtable
    # preload ops (tenant_ids < 0) are never visited: always admitted
    for i, ti, t, s, svc_i, w in zip(
            offered.tolist(), np.asarray(tenant_ids)[offered].tolist(),
            np.asarray(arrivals, np.float64)[offered].tolist(),
            np.asarray(shard_ids)[offered].tolist(), svc[offered].tolist(),
            is_write[offered].tolist()):
        if not buckets[ti].try_admit(t):
            verdicts[i] = THROTTLE
            continue
        l0_est[s] = max(0.0, l0_est[s] - (t - l0_t_s[s]) / l0_drain_s)
        l0_t_s[s] = t
        if sheddable[ti]:
            delay_est_s = max(0.0, depart_est_s[s] - t)
            if delay_est_s > threshold_s[ti] or (
                    w and l0_est[s] >= acfg.l0_shed_depth):
                verdicts[i] = SHED
                continue
        depart_est_s[s] = max(depart_est_s[s], t) + svc_i
        if w:
            fill_bytes[s] += cfg.kv_size
            if fill_bytes[s] >= cfg.memtable_size:
                fill_bytes[s] -= cfg.memtable_size
                l0_est[s] += 1.0
    return verdicts
