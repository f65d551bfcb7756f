"""YCSB / db_bench workload generators (key streams + op mixes).

Host-side numpy generators from ``default_rng`` seeds, identical to the
reference's, so both packages replay the same key streams.

The paper's methodology (§5): YCSB Load A (100% insert) for write tails,
Run A (50r/50u), Run B (95r/5u), Run C (100r), Run D (95 read-latest /
5 insert), Run E (95 scan / 5 insert — the range-query workload); uniform
and Zipfian(0.99) request distributions; db_bench-style fillrandom with
uniform and Pareto key popularity (Meta's production mix).

Op streams are typed (:class:`repro_torch.core.OpKind`): 0 PUT, 1 GET, 2 DELETE,
3 SCAN; SCAN ops carry a per-op requested key count in ``scan_lens``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import OpKind

KEYSPACE = 1 << 48


@dataclass
class WorkloadSpec:
    name: str
    op_types: np.ndarray       # OpKind values
    keys: np.ndarray
    scan_lens: np.ndarray | None = None   # per-op SCAN key count (None: no scans)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def load_keys(n: int, seed: int = 7) -> np.ndarray:
    """Distinct-ish uniform keys for the load phase."""
    return _rng(seed).integers(0, KEYSPACE, size=n, dtype=np.int64)


def _zipf_rank_sample(m: int, n: int, theta: float, seed: int) -> np.ndarray:
    """Sample ``n`` ranks in [0, m) with probability ∝ 1/(rank+1)^theta
    via inverse-CDF over the (normalized) generalized harmonic cumsum —
    exact, vectorized.  Shared by both zipf key mappers."""
    ranks = np.arange(1, m + 1, dtype=np.float64)
    w = 1.0 / ranks ** theta
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = _rng(seed).random(n)
    return np.searchsorted(cdf, u, side="left")


def zipf_keys(population: np.ndarray, n: int, theta: float = 0.99,
              seed: int = 11) -> np.ndarray:
    """YCSB-style Zipfian sampling over an item population."""
    m = population.shape[0]
    idx = _zipf_rank_sample(m, n, theta, seed)
    # YCSB scatters the hot ranks across the keyspace via a hash; shuffling
    # the population achieves the same decorrelation.
    perm = _rng(seed + 1).permutation(m)
    return population[perm[idx]]


def zipf_ranked_keys(population: np.ndarray, n: int, theta: float = 0.99,
                     seed: int = 11) -> np.ndarray:
    """Zipfian sampling WITHOUT YCSB's scatter permutation: rank *r* maps
    to the r-th **smallest** key, so popularity decays along the key
    order.  This is the hot-range request pattern — and, over a
    range-partitioned keyspace, the canonical *hot-shard* scenario: the
    shard owning the head of the key order absorbs most of the traffic
    while its neighbours idle (``db_bench``'s ``shard_sweep`` hot-shard
    rows drive exactly this against the ``range`` router)."""
    idx = _zipf_rank_sample(population.shape[0], n, theta, seed)
    return np.sort(population)[idx]


def pareto_keys(population: np.ndarray, n: int, alpha: float = 1.16,
                seed: int = 13) -> np.ndarray:
    """Pareto popularity (db_bench's Meta-production-like distribution).

    Rank *i* gets the exact probability mass of the Pareto (Lomax) density
    on [i, i+1) — ``w_i = (1+i)^-alpha - (2+i)^-alpha`` — sampled by
    inverse-CDF over the normalized cumsum, mirroring :func:`zipf_keys`.
    A rank's popularity is a fixed function of (rank, alpha, m): unlike
    the old ``raw / raw.max()`` normalization, it does not depend on the
    sample size ``n`` (the max of ``n`` Pareto draws grows with ``n``, so
    the old mapping reshuffled popularity whenever ``n`` changed).
    """
    m = population.shape[0]
    edges = np.arange(m + 1, dtype=np.float64)
    cdf = np.cumsum((1.0 + edges[:-1]) ** -alpha - (1.0 + edges[1:]) ** -alpha)
    cdf /= cdf[-1]
    u = _rng(seed).random(n)
    idx = np.searchsorted(cdf, u, side="left")
    perm = _rng(seed + 1).permutation(m)
    return population[perm[idx]]


def make_load_a(n: int, seed: int = 7) -> WorkloadSpec:
    return WorkloadSpec("load_a", np.zeros(n, np.uint8), load_keys(n, seed))


def _mixed(name: str, population: np.ndarray, n: int, read_frac: float,
           dist: str, seed: int) -> WorkloadSpec:
    r = _rng(seed)
    op_types = (r.random(n) < read_frac).astype(np.uint8)  # 1 = read
    if dist == "zipfian":
        keys = zipf_keys(population, n, seed=seed + 2)
    elif dist == "zipf_ranked":
        keys = zipf_ranked_keys(population, n, seed=seed + 2)
    elif dist == "pareto":
        keys = pareto_keys(population, n, seed=seed + 2)
    else:
        keys = population[r.integers(0, population.shape[0], size=n)]
    return WorkloadSpec(name, op_types, keys)


def make_run_a(population: np.ndarray, n: int, dist: str = "uniform",
               seed: int = 21) -> WorkloadSpec:
    return _mixed("run_a", population, n, 0.5, dist, seed)


def make_run_b(population: np.ndarray, n: int, dist: str = "uniform",
               seed: int = 23) -> WorkloadSpec:
    return _mixed("run_b", population, n, 0.95, dist, seed)


def make_run_c(population: np.ndarray, n: int, dist: str = "uniform",
               seed: int = 25) -> WorkloadSpec:
    return _mixed("run_c", population, n, 1.0, dist, seed)


def make_run_e(population: np.ndarray, n: int, dist: str = "zipfian",
               seed: int = 29, max_scan_len: int = 100) -> WorkloadSpec:
    """YCSB-E: 95% SCAN / 5% insert.  Scan start keys follow the request
    distribution; scan lengths are uniform in [1, max_scan_len] (the YCSB
    default).  Inserts add fresh keys, as YCSB-E's INSERT phase does."""
    r = _rng(seed)
    op_types = np.where(r.random(n) < 0.95, np.uint8(OpKind.SCAN),
                        np.uint8(OpKind.PUT))
    keys = np.empty(n, np.int64)
    inserts = np.nonzero(op_types == OpKind.PUT)[0]
    keys[inserts] = load_keys(inserts.shape[0], seed + 1)
    scans = np.nonzero(op_types == OpKind.SCAN)[0]
    if dist == "zipfian":
        starts = zipf_keys(population, scans.shape[0], seed=seed + 2)
    elif dist == "pareto":
        starts = pareto_keys(population, scans.shape[0], seed=seed + 2)
    else:
        starts = population[r.integers(0, population.shape[0],
                                       size=scans.shape[0])]
    keys[scans] = starts
    scan_lens = np.zeros(n, np.int32)
    scan_lens[scans] = r.integers(1, max_scan_len + 1, size=scans.shape[0])
    return WorkloadSpec("run_e", op_types, keys, scan_lens)


def make_run_d(population: np.ndarray, n: int, seed: int = 27) -> WorkloadSpec:
    """95% read-latest / 5% insert."""
    r = _rng(seed)
    op_types = (r.random(n) < 0.95).astype(np.uint8)
    keys = np.empty(n, np.int64)
    inserts = np.nonzero(op_types == 0)[0]
    keys[inserts] = load_keys(inserts.shape[0], seed + 1)
    # read-latest: sample recent inserts with geometric recency bias
    reads = np.nonzero(op_types == 1)[0]
    pool = np.concatenate([population, keys[inserts]])
    lag = r.geometric(p=0.01, size=reads.shape[0])
    idx = np.maximum(pool.shape[0] - lag, 0)
    keys[reads] = pool[idx]
    return WorkloadSpec("run_d", op_types, keys)
