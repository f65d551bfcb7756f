"""Serving layer of the port: LLM-serving scaffolding (paged KV pool, the
LSM-backed prefix cache) plus the open-loop traffic/admission layer over
the store.

``traffic`` materializes multi-tenant :class:`TrafficSpec` scenarios into
simulated-time-ordered op streams and drives either engine on its compute
device; ``admission`` is the deterministic pre-pass controller (token
buckets, priority-aware shedding) in front of each shard's foreground
queue.
"""

from .admission import (ADMIT, SHED, THROTTLE, AdmissionConfig,
                        TokenBucket, admit)
from .kv_cache import PagePool, Sequence
from .prefix_cache import PrefixCache
from .traffic import (ServeResult, TenantSpec, TrafficSpec, TrafficStream,
                      bursty_arrivals, deterministic_arrivals, materialize,
                      poisson_arrivals, serve, serve_grid)

__all__ = [
    "ADMIT", "AdmissionConfig", "PagePool", "PrefixCache", "SHED",
    "THROTTLE", "ServeResult", "Sequence", "TenantSpec", "TokenBucket",
    "TrafficSpec", "TrafficStream", "admit", "bursty_arrivals",
    "deterministic_arrivals", "materialize", "poisson_arrivals", "serve",
    "serve_grid",
]
