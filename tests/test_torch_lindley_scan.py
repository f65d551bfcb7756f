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
from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                  lindley_batch_plain)


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
