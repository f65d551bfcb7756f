"""Admission control for serving: the token bucket of
``repro/serving/admission.py``.  The deterministic pre-pass controller over
the store (``AdmissionConfig``, ``admit``) waits for the traffic/admission
slice (ROADMAP queue 1, item 4)."""

from __future__ import annotations


class TokenBucket:
    """Classic token bucket over *simulated* arrival times.

    Capacity ``burst_ops`` tokens, refilled continuously at
    ``rate_ops_s``; an op is admitted iff a whole token is available at
    its arrival instant.  Over any window ``[t1, t2]`` the bucket admits
    at most ``burst_ops + rate_ops_s * (t2 - t1)`` ops.
    ``rate_ops_s <= 0`` disables the limit.
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
