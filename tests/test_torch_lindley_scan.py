"""Port of the lindley_scan kernel (the batched FIFO departure recursion)
against the JAX reference on the CPU.

The reference's Pallas kernel runs in interpret mode under
``jax.enable_x64(True)``; it pads rows to [B, N] and re-associates the
cumsum per 128-op tile, so it is held to the port's plain version within
1e-12 s (float64 round-off at ~1e2 s clocks).  Against ``lindley_numpy``,
the parity anchor of the reference's DES pass, the plain version follows
the same operation order row by row and must agree bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.lindley_scan.kernel import lindley_scan_call
from repro.kernels.lindley_scan.ops import lindley_numpy
from repro_torch.kernels.lindley_scan import ops
from repro_torch.kernels.lindley_scan.ops import (TILE, lindley_batch,
                                                  lindley_batch_plain, plan)


def _queue(rng, n: int, rate: float = 2e5):
    service = rng.exponential(3e-6, n)
    arrivals = 50.0 + np.cumsum(rng.exponential(1.0 / rate, n))
    return service, arrivals


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    b, n = 3, 384
    qs = [_queue(rng, n) for _ in range(b)]
    S = np.stack([q[0] for q in qs])
    A = np.stack([q[1] for q in qs])
    d0 = np.array([-np.inf, 50.001, 49.0])
    with jax.enable_x64(True):
        want = np.asarray(lindley_scan_call(S, A, d0, interpret=True))
    offsets = np.arange(b + 1) * n
    got = lindley_batch_plain(torch.from_numpy(S.ravel()),
                              torch.from_numpy(A.ravel()), offsets, d0)
    assert float(np.max(np.abs(got.numpy() - want.ravel()))) < 1e-12


@pytest.mark.parametrize("lens,d0", [
    ([1], [-np.inf]),
    ([0, 5, 0, 300], [-np.inf, 49.0, 0.0, 50.002]),
    ([1000, 1, 2500], [-np.inf, -np.inf, 60.0]),
    ([0, 0], None),
])
def test_ragged_batch_bit_identical_to_lindley_numpy(lens, d0):
    rng = np.random.default_rng(sum(lens))
    qs = [_queue(rng, m) for m in lens]
    service = np.concatenate([q[0] for q in qs])
    arrivals = np.concatenate([q[1] for q in qs])
    offsets = np.concatenate([[0], np.cumsum(lens)])
    launches = lindley_batch.launches
    got = lindley_batch(torch.from_numpy(service), torch.from_numpy(arrivals),
                        offsets, d0).numpy()
    assert lindley_batch.launches == launches    # CPU: plain version only
    for r, (s, a) in enumerate(qs):
        d = -np.inf if d0 is None else d0[r]
        np.testing.assert_array_equal(got[offsets[r]:offsets[r + 1]],
                                      lindley_numpy(s, a, d))


def test_lindley_checks_input():
    s = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        lindley_batch(s, s, [0, 3])          # offsets must end at 4
    with pytest.raises(ValueError):
        lindley_batch(s, s, [0, 4], [0.0, 1.0])
    with pytest.raises(TypeError):
        lindley_batch(s.float(), s.float(), [0, 4])


def _unpack(packed, rows):
    off = packed[:rows + 1]
    first = packed[rows + 1:2 * rows + 2]
    d0 = packed[2 * rows + 2:3 * rows + 2].view(np.float64)
    return off, first, d0, packed[3 * rows + 2:]


@pytest.mark.parametrize("lens", [
    [0, 5, 0, 300],
    [TILE - 1, TILE, TILE + 1, 3 * TILE + 5],
    [0, 0],
    [2 * TILE, 1, 0, 2 * TILE + 2],
])
def test_plan_tiles_follow_lindley_numpy(lens):
    """The kernel's tile plan of a ragged batch: each row's tiles are
    consecutive, at most TILE ops each, and cover the row in order; the
    reference's numpy recursion run tile by tile, each tile's d0 the last
    departure before it, gives each row's departures (within 1e-12 s)."""
    rng = np.random.default_rng(len(lens) + sum(lens))
    qs = [_queue(rng, m) for m in lens]
    d0 = [50.0 + r for r in range(len(lens))]
    offsets = np.concatenate([[0], np.cumsum(lens)])
    packed, tiles, _ = plan(offsets, d0, int(offsets[-1]))
    off, first, d0_bits, rows = _unpack(packed, len(lens))
    np.testing.assert_array_equal(off, offsets)
    np.testing.assert_array_equal(d0_bits, d0)
    assert rows.shape == (tiles,)
    for r, (s, a) in enumerate(qs):
        ids = np.flatnonzero(rows == r)
        assert ids.size == -(-lens[r] // TILE)
        np.testing.assert_array_equal(ids, first[r] + np.arange(ids.size))
        want = lindley_numpy(s, a, d0[r])
        got, last, end = [], d0[r], 0
        for t in ids:
            begin = (t - int(first[r])) * TILE    # within the row
            end = min(begin + TILE, lens[r])
            assert 0 < end - begin <= TILE
            part = lindley_numpy(s[begin:end], a[begin:end], last)
            got.append(part)
            last = part[-1]
        assert end == lens[r]
        if lens[r]:
            np.testing.assert_allclose(np.concatenate(got), want, rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("n,d0", [(0, None), (1, None), (TILE, [2.5]),
                                  (10 * TILE + 1, [-np.inf])])
def test_plan_one_row_travels_as_scalars(n, d0):
    packed, tiles, d0v = plan([0, n], d0, n)
    assert packed is None
    assert tiles == -(-n // TILE)
    assert d0v == (-np.inf if d0 is None else d0[0])


def test_plan_checks_input():
    for offsets, d0, n in (([0, 3], None, 4), ([1, 4], None, 4),
                           ([0, 4], [0.0, 1.0], 4), ([0, 5, 4], None, 4),
                           ([0, 2, 4], [1.0], 4)):
        with pytest.raises(ValueError):
            plan(offsets, d0, n)


@pytest.mark.parametrize("tile", [TILE, TILE // 2])
def test_resolve_checks_the_library_tile(monkeypatch, tile):
    """The wrapper takes a kernel library only if the tile its
    ``lindley_scan_tile`` entry reports is ops.TILE (the plan is cut into
    TILE-op tiles); a library of another tile raises and leaves the entry
    unresolved."""
    launch = object()
    entries = {"lindley_scan_tile": lambda: tile,
               "lindley_scan_launch": launch}
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
