"""Port of the merge_path kernel and the latest-wins k-run merge, against the
JAX reference on the CPU.

The reference's Pallas merge kernel cannot run on JAX 0.9.0, not even in
interpret mode: ``jax.experimental.pallas`` has no ``load`` any more, so
``repro.kernels.merge_path.ops.merge_two_runs_np`` raises AttributeError
(``kernel.py:57``).  The port's plain merge is therefore held against the
pure-jnp oracle ``merge_two_runs_ref`` (under ``jax.enable_x64(True)``, so
int64 keys are not narrowed), and ``merge_runs`` against the reference's
numpy tier.  The CUDA kernel is held against the plain version on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merge import merge_runs as ref_merge_runs
from repro.kernels.merge_path.ref import merge_two_runs_ref
from repro_torch.core.merge import merge_runs
from repro_torch.kernels.merge_path import ops
from repro_torch.kernels.merge_path.ops import (TILE, merge_two_runs,
                                                merge_two_runs_plain)
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

BIG = 2 ** 62


def _oracle(a, sa, b, sb):
    with jax.enable_x64(True):
        k, s = merge_two_runs_ref(jnp.asarray(a), jnp.asarray(sa),
                                  jnp.asarray(b), jnp.asarray(sb))
        return np.asarray(k, np.int64), np.asarray(s, np.int64)


def _case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties":
        a, b = np.array([1, 3, 5, 7]), np.array([3, 5, 8])
    elif name == "empty_a":
        a, b = np.array([], np.int64), np.array([2, 4, 6])
    elif name == "empty_b":
        a, b = np.array([-5, 0]), np.array([], np.int64)
    elif name == "extremes":
        a = np.array([-BIG, -1, 0, BIG])
        b = np.array([-BIG, 0, 1, BIG])
    else:
        a = np.unique(rng.integers(-BIG, BIG, 300))
        b = np.unique(np.concatenate([rng.choice(a, 40),
                                      rng.integers(-BIG, BIG, 200)]))
    a, b = a.astype(np.int64), b.astype(np.int64)
    # seqs beyond int32: the reference kernel's 2^31 payload limit is gone
    sa = rng.integers(2 ** 31, 2 ** 40, a.shape[0]).astype(np.int64)
    sb = rng.integers(2 ** 31, 2 ** 40, b.shape[0]).astype(np.int64)
    return a, sa, b, sb


@pytest.mark.parametrize("name", ["ties", "empty_a", "empty_b", "extremes",
                                  "random0", "random1", "random2"])
def test_plain_merge_matches_jnp_oracle(name):
    a, sa, b, sb = _case(name)
    want_k, want_s = _oracle(a, sa, b, sb)
    launches = merge_two_runs.launches
    for fn in (merge_two_runs_plain, merge_two_runs):
        k, s = fn(*(torch.from_numpy(x) for x in (a, sa, b, sb)))
        np.testing.assert_array_equal(k.numpy(), want_k)
        np.testing.assert_array_equal(s.numpy(), want_s)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert merge_two_runs.launches == launches


def _runs(k: int, seed: int, with_empty: bool):
    """k newest-first runs; a newer run's seqs are higher for every key, and
    seqs carry the tombstone tag bit (enc = seq << 1 | tomb)."""
    rng = np.random.default_rng(seed)
    runs = []
    for i in range(k):
        keys = np.unique(rng.integers(0, 2_000, rng.integers(1, 400)))
        keys = keys.astype(np.int64) + (2 ** 50)
        logical = (k - i) * 2 ** 33 + np.arange(keys.shape[0])
        tomb = rng.random(keys.shape[0]) < 0.2
        runs.append((keys, (logical << 1) | tomb.astype(np.int64)))
    if with_empty:
        runs.insert(1, (np.empty(0, np.int64), np.empty(0, np.int64)))
    return runs


@pytest.mark.parametrize("k,seed,with_empty", [
    (1, 0, False), (2, 1, False), (3, 2, True), (5, 3, False), (9, 4, True)])
def test_merge_runs_matches_numpy_tier(k, seed, with_empty):
    runs = _runs(k, seed, with_empty)
    want_k, want_s = ref_merge_runs(runs)
    got_k, got_s = merge_runs([(torch.from_numpy(a), torch.from_numpy(b))
                               for a, b in runs])
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert int(got_s.max()) >= 2 ** 31


def test_merge_rejects_bad_input():
    k = torch.arange(4)
    with pytest.raises(TypeError):
        merge_two_runs(k.to(torch.int32), k, k, k)
    with pytest.raises(ValueError):
        merge_two_runs(k, k[:3], k, k)
    with pytest.raises(TypeError):
        merge_two_runs(k, k, k[None], k[None])
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):         # runs on two devices
        merge_two_runs(k, k, meta, meta)
    with pytest.raises(ValueError):         # neither the CPU nor a card
        merge_two_runs(meta, meta, meta, meta)


@pytest.mark.parametrize("name", ["ties", "extremes", "random0"])
def test_merge_takes_strided_runs(name):
    """Views with a stride (every other element of a buffer twice the
    length) merge as their contiguous copies do."""
    a, sa, b, sb = _case(name)
    want_k, want_s = _oracle(a, sa, b, sb)
    views = []
    for x in (a, sa, b, sb):
        buf = torch.zeros(2 * x.shape[0], dtype=torch.int64)
        buf[::2] = torch.from_numpy(x)
        views.append(buf[::2])
    assert not views[0].is_contiguous() or a.shape[0] < 2
    k, s = merge_two_runs(*views)
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_array_equal(s.numpy(), want_s)


@pytest.mark.parametrize("tile", [TILE, TILE // 2])
def test_resolve_checks_the_library_tile(monkeypatch, tile):
    """The wrapper takes a kernel library only if the tile its
    ``merge_path_tile`` entry reports is ops.TILE (the card's edge checks
    cut runs around TILE); a library of another tile raises and leaves the
    entry unresolved."""
    launch = object()
    entries = {"merge_path_tile": lambda: tile,
               "merge_path_launch": launch}
    monkeypatch.setattr(ops._build, "load",
                        lambda name, fn, argtypes: entries[fn])
    monkeypatch.setattr(ops, "_launch", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", object(),
                        raising=False)
    if tile == TILE:
        ops._resolve()
        assert ops._launch is launch
    else:
        with pytest.raises(RuntimeError, match="tile"):
            ops._resolve()
        assert ops._launch is None


def test_merge_runs_is_independent_of_run_order():
    """A scan's gather hands runs in no particular order; max seq still wins."""
    runs = _runs(6, 9, True)
    shuffled = [runs[i] for i in np.random.default_rng(0).permutation(7)]
    want_k, want_s = ref_merge_runs(runs)
    got_k, got_s = merge_runs([(torch.from_numpy(a), torch.from_numpy(b))
                               for a, b in shuffled])
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
