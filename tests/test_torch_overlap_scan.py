"""Port of the overlap_scan kernel (the sorted-array rank) against the JAX
reference on the CPU.

The reference's Pallas rank kernel cannot run on JAX 0.9.0, not even in
interpret mode (``pl.load`` is gone: ``fence_rank_np`` raises at
``kernels/overlap_scan/kernel.py:39``), so the port's ranks are held against
the pure-jnp oracle ``fence_rank_ref`` under ``jax.enable_x64(True)`` and
against ``np.searchsorted``.  The port computes the strict rank directly,
so INT64_MIN and INT64_MAX keys need none of the reference's special cases.

The edge sizes sit around 2^12 - 1 and 6,144 fences, where a search that
stages the top of the tree, or the whole array, in shared memory would
change paths; the shipped CUDA kernel is the plain binary search that
:func:`fence_rank_plain` is, and ``chip_smoke.py`` holds it to both on the
card at the same sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.overlap_scan.ref import fence_rank_ref
from repro_torch.kernels.overlap_scan.ops import fence_rank, fence_rank_plain

LO, HI = np.iinfo(np.int64).min, np.iinfo(np.int64).max
# around 2^12 - 1 fences and 6,144 fences
EDGE_SIZES = [4094, 4095, 4096, 4097, 6143, 6144, 6145]


def _fences(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name))
    if name.startswith("n"):              # "n<size>": sorted, with runs
        return np.sort(rng.integers(-3000, 3000, int(name[1:])))
    return {
        "empty": np.array([], np.int64),
        "single": np.array([7], np.int64),
        "duplicates": np.array([3, 3, 3, 9, 9, 12], np.int64),
        "extremes": np.array([LO, -1, 0, HI], np.int64),
        "extreme_runs": np.array([LO] * 40 + [0] * 3000 + [HI] * 1500,
                                 np.int64),
        "random": np.sort(rng.integers(-10 ** 12, 10 ** 12, 1000)),
        "random_dups": np.sort(rng.integers(-40, 40, 700)),
        "large": np.sort(rng.integers(-10 ** 15, 10 ** 15, 100_000)),
    }[name]


FENCE_NAMES = ["empty", "single", "duplicates", "extremes", "extreme_runs",
               "random", "random_dups", "large",
               *(f"n{n}" for n in EDGE_SIZES)]


def _keys() -> np.ndarray:
    rng = np.random.default_rng(5)
    return np.concatenate([
        [LO, LO + 1, HI - 1, HI, -1, 0, 3, 7, 9, 12],
        rng.integers(-50, 50, 300), rng.integers(-10 ** 12, 10 ** 12, 300),
    ]).astype(np.int64)


@pytest.mark.parametrize("fname", FENCE_NAMES)
@pytest.mark.parametrize("side", ["right", "left"])
def test_rank_matches_searchsorted(fname, side):
    fences, keys = _fences(fname), _keys()
    want = np.searchsorted(fences, keys, side=side)
    f, k = torch.from_numpy(fences), torch.from_numpy(keys)
    launches = fence_rank.launches
    np.testing.assert_array_equal(fence_rank_plain(f, k, side).numpy(), want)
    np.testing.assert_array_equal(fence_rank(f, k, side).numpy(), want)
    assert fence_rank.launches == launches     # CPU: plain version only


@pytest.mark.parametrize("fname", [f for f in FENCE_NAMES if f != "empty"])
def test_rank_matches_jnp_oracle(fname):
    fences, keys = _fences(fname), _keys()
    with jax.enable_x64(True):
        right = np.asarray(fence_rank_ref(jnp.asarray(fences),
                                          jnp.asarray(keys)))
        # the reference's strict rank is the inclusive rank of key - 1,
        # defined for keys above INT64_MIN
        inner = keys[keys > LO]
        strict = np.asarray(fence_rank_ref(jnp.asarray(fences),
                                           jnp.asarray(inner - 1)))
    f, k = torch.from_numpy(fences), torch.from_numpy(keys)
    np.testing.assert_array_equal(fence_rank(f, k, "right").numpy(), right)
    np.testing.assert_array_equal(
        fence_rank(f, torch.from_numpy(inner), "left").numpy(), strict)


def test_rank_keeps_shape_and_checks_input():
    f = torch.tensor([1, 5, 9])
    k = torch.tensor([[0, 5], [9, 10]])
    assert fence_rank(f, k, "right").tolist() == [[0, 2], [3, 3]]
    with pytest.raises(ValueError):
        fence_rank(f, k, "middle")
    with pytest.raises(TypeError):
        fence_rank(f.to(torch.int32), k)


def test_rank_takes_strided_keys():
    """Non-contiguous keys (the card path copies them once; the plain path
    reads them as they are) rank as their contiguous copy does."""
    fences = torch.from_numpy(_fences("random_dups"))
    keys = torch.from_numpy(_keys()).view(-1, 2)[:, 1]
    assert not keys.is_contiguous()
    np.testing.assert_array_equal(
        fence_rank(fences, keys, "left").numpy(),
        np.searchsorted(fences.numpy(), keys.numpy(), "left"))
