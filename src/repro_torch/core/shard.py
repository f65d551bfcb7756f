"""Keyspace sharding: the ``ShardRouter`` partition function.

:class:`ShardRouter` maps keys to shards: ``"hash"`` mixes the key through
a splitmix64 finalizer (load spreads evenly, ranges scatter across shards);
``"range"`` stripes the key domain ``[0, shard_key_space)`` into contiguous
shards.  Routing is host-side control (one numpy pass per op stream), as in
the reference; the multi-tree ``ShardedStore`` container is still to be
ported.
"""

from __future__ import annotations

import numpy as np

from .types import LSMConfig


def hash_keys(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over int64 keys -> uint64 mix.

    The standard 64-bit avalanche (shift-xor / odd-constant multiply
    rounds): adjacent keys land on unrelated shards, so range-local load
    cannot pile onto one shard under the hash router.
    """
    x = np.asarray(keys, np.int64).astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class ShardRouter:
    """The keyspace partition function: ``shard_of(keys) -> shard ids``.

    Deterministic, vectorized, and a *partition*: every key maps to
    exactly one shard in ``[0, n_shards)`` (property-tested).
    """

    def __init__(self, n_shards: int, kind: str = "hash",
                 key_space: int = 1 << 48):
        assert n_shards >= 1
        assert kind in ("hash", "range"), f"unknown router kind {kind!r}"
        self.n_shards = int(n_shards)
        self.kind = kind
        self.key_space = int(key_space)
        # range stripe width, rounded up so stripe*n covers the domain
        self._stripe = max(1, -(-self.key_space // self.n_shards))

    @staticmethod
    def from_config(cfg: LSMConfig) -> "ShardRouter":
        return ShardRouter(cfg.n_shards, cfg.shard_router,
                           cfg.shard_key_space)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Shard id (int64) for each key — one columnar pass."""
        keys = np.asarray(keys, np.int64)
        if self.n_shards == 1:
            return np.zeros(keys.shape[0], np.int64)
        if self.kind == "hash":
            return (hash_keys(keys) % np.uint64(self.n_shards)) \
                .astype(np.int64)
        # range: contiguous stripes; keys outside the declared domain
        # clamp to the edge shards instead of wrapping
        return np.clip(keys // self._stripe, 0, self.n_shards - 1)
