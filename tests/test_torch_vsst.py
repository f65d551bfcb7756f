"""Port of vSST planning and good-vSST selection (paper §4.2) against the
reference on the CPU: identical plans and picks on random merged streams
and L2 fence tables."""

import numpy as np
import pytest
import torch

import repro.core.vsst as ref_vsst
from repro.core.sst import SST as RefSST
from repro_torch.core import vsst as port_vsst
from repro_torch.core.sst import SST as PortSST

KV = 200


def _case(seed: int, n_l2: int, n_keys: int):
    rng = np.random.default_rng(seed)
    l2 = np.unique(rng.integers(0, 10 ** 7, n_l2 * 20)).astype(np.int64)
    cuts = np.array_split(l2, max(1, n_l2)) if n_l2 else []
    fence_lo = np.array([c[0] for c in cuts], np.int64)
    fence_hi = np.array([c[-1] for c in cuts], np.int64)
    keys = np.unique(rng.integers(0, 10 ** 7, n_keys)).astype(np.int64)
    return keys, fence_lo, fence_hi


def _plans(plans):
    return [(p.start, p.end, p.overlap_ssts, p.good) for p in plans]


@pytest.mark.parametrize("seed,n_l2,n_keys,f", [
    (0, 0, 500, 8), (1, 40, 900, 8), (2, 200, 3000, 8), (3, 64, 2000, 2),
    (4, 500, 4000, 8), (5, 10, 60, 4)])
def test_plan_vssts_matches(seed, n_l2, n_keys, f):
    keys, fence_lo, fence_hi = _case(seed, n_l2, n_keys)
    s_m, s_M = 16 * KV, 128 * KV
    want = ref_vsst.plan_vssts(keys, KV, s_m, s_M, f, fence_lo, fence_hi,
                               s_M)
    args = (torch.from_numpy(keys), KV, s_m, s_M, f,
            torch.from_numpy(fence_lo), torch.from_numpy(fence_hi), s_M)
    assert _plans(port_vsst.plan_vssts(*args)) == _plans(want)


@pytest.mark.parametrize("seed,precomputed", [(0, False), (1, True),
                                              (2, False), (3, True)])
def test_select_good_vssts_matches(seed, precomputed):
    rng = np.random.default_rng(seed)
    keys, fence_lo, fence_hi = _case(seed, 120, 6000)
    bounds = np.sort(rng.choice(np.arange(1, keys.shape[0]), 30,
                                replace=False))
    ref_l1, port_l1 = [], []
    for c in np.split(keys, bounds):
        ref_l1.append(RefSST(c, np.zeros_like(c), KV))
        port_l1.append(PortSST(torch.from_numpy(c), torch.zeros(c.shape[0],
                                                                dtype=torch.int64), KV))
    ov = None
    if precomputed:
        s_lo = np.array([s.smallest for s in ref_l1])
        s_hi = np.array([s.largest for s in ref_l1])
        ov = np.maximum(0, np.searchsorted(fence_lo, s_hi, "right")
                        - np.searchsorted(fence_hi, s_lo, "left"))
    for needed in (KV, 50 * KV, 400 * KV):
        want = ref_vsst.select_good_vssts(ref_l1, fence_lo, fence_hi,
                                          128 * KV, 8, needed, ov=ov)
        got = port_vsst.select_good_vssts(
            port_l1, torch.from_numpy(fence_lo), torch.from_numpy(fence_hi),
            128 * KV, 8, needed, ov=ov)
        assert got == want
