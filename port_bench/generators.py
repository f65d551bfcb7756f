"""The benchmark's traffic generators: frozen copies of the program's.

``load_keys``, ``_zipf_rank_sample``, ``zipf_keys`` and ``_mixed`` are
copied from ``repro_torch.bench_kv.workloads`` and ``ycsb_trace`` from
``chip_smoke.ycsb_trace``, so that a later change to the program cannot
change the traffic it is measured on.  ``port_bench/tests`` holds them to
the originals at one seed.  Nothing here imports the program: it receives
only the arrays made here.

``zipf_index`` is ``zipf_keys`` stopped one step short: the population
index of every sampled key, which the served traffic needs to build its
reference without searching the population.
"""

from __future__ import annotations

import numpy as np

KEYSPACE = 1 << 48


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def load_keys(n: int, seed: int = 7) -> np.ndarray:
    """Distinct-ish uniform keys for the load phase."""
    return _rng(seed).integers(0, KEYSPACE, size=n, dtype=np.int64)


def unique_sorted(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by a sort: the same array; NumPy 2.3.5's
    ``np.unique`` took 13.3 s over 8 M keys on the H100's host."""
    s = np.sort(keys)
    keep = np.empty(s.shape[0], bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _zipf_rank_sample(m: int, n: int, theta: float, seed: int) -> np.ndarray:
    """``n`` ranks in [0, m) with probability proportional to
    1/(rank+1)^theta, by inverse CDF over the generalized harmonic sums."""
    ranks = np.arange(1, m + 1, dtype=np.float64)
    w = 1.0 / ranks ** theta
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = _rng(seed).random(n)
    return np.searchsorted(cdf, u, side="left")


def zipf_index(m: int, n: int, theta: float = 0.99,
               seed: int = 11) -> np.ndarray:
    """Population indices of ``zipf_keys``' samples."""
    idx = _zipf_rank_sample(m, n, theta, seed)
    # YCSB scatters the hot ranks over the keyspace with a hash; a
    # permutation of the population does the same.
    perm = _rng(seed + 1).permutation(m)
    return perm[idx]


def zipf_keys(population: np.ndarray, n: int, theta: float = 0.99,
              seed: int = 11) -> np.ndarray:
    """YCSB-style Zipfian sampling over an item population."""
    return population[zipf_index(population.shape[0], n, theta, seed)]


def mixed_index(m: int, n: int, read_frac: float, seed: int,
                theta: float = 0.99) -> tuple[np.ndarray, np.ndarray]:
    """``_mixed``'s Zipfian op kinds (1 read, 0 update) and the population
    index of each op's key."""
    r = _rng(seed)
    op_types = (r.random(n) < read_frac).astype(np.uint8)
    return op_types, zipf_index(m, n, theta, seed=seed + 2)


def _mixed(population: np.ndarray, n: int, read_frac: float, seed: int,
           theta: float = 0.99) -> tuple[np.ndarray, np.ndarray]:
    """YCSB Run A/B/C's op kinds and Zipfian keys: ``_mixed(name,
    population, n, read_frac, "zipfian", seed)`` of the program."""
    op_types, idx = mixed_index(population.shape[0], n, read_frac, seed,
                                theta)
    return op_types, population[idx]


def ycsb_trace(n_load: int, n_run: int, seed: int = 7, *,
               read_frac: float = 0.5, theta: float = 0.99,
               run_seed: int = 21,
               load_rate: float = 500_000.0, settle_s: float = 10.0,
               run_rate: float = 8_000.0):
    """Load (unique uniform keys at ``load_rate``), a settle of
    ``settle_s``, then the Zipfian run at ``run_rate``: ``(ops, keys,
    arrivals, n_loaded)``.  With the defaults, ``chip_smoke.ycsb_trace``."""
    return ycsb_trace_index(n_load, n_run, seed, read_frac=read_frac,
                            theta=theta, run_seed=run_seed,
                            load_rate=load_rate, settle_s=settle_s,
                            run_rate=run_rate)[:4]


def ycsb_trace_index(n_load: int, n_run: int, seed: int = 7, *,
                     read_frac: float = 0.5, theta: float = 0.99,
                     run_seed: int = 21, load_rate: float = 500_000.0,
                     settle_s: float = 10.0, run_rate: float = 8_000.0):
    """:func:`ycsb_trace` and, last, the population index of every op's
    key (the load writes the population in order)."""
    pop = unique_sorted(load_keys(n_load, seed=seed))
    run_ops, run_idx = mixed_index(pop.shape[0], n_run, read_frac, run_seed,
                                   theta)
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), run_ops])
    keys = np.concatenate([pop, pop[run_idx]])
    load = np.arange(pop.shape[0], dtype=np.float64) / load_rate
    run = load[-1] + settle_s + np.arange(n_run, dtype=np.float64) / run_rate
    key_idx = np.concatenate([np.arange(pop.shape[0]), run_idx])
    return ops, keys, np.concatenate([load, run]), pop.shape[0], key_idx
