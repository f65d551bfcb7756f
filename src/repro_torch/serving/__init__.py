"""Serving layer of the port: paged KV pool, the LSM-backed prefix cache,
the admission token bucket and the arrival generators."""

from .admission import TokenBucket
from .kv_cache import PagePool, Sequence
from .prefix_cache import PrefixCache
from .traffic import deterministic_arrivals, poisson_arrivals

__all__ = ["PagePool", "PrefixCache", "Sequence", "TokenBucket",
           "deterministic_arrivals", "poisson_arrivals"]
