"""Port of the paged_attention kernel against the JAX reference on the CPU.

The port's wrapper gets CPU tensors, so it runs its plain version
(``paged_attention_plain``); the reference runs its Pallas kernel in
interpret mode (``repro.kernels.paged_attention.paged_attention``) and its
``ref.py`` oracle on the same numpy-seeded inputs.  Tolerance: the
reference's own (``tests/test_kernels.py``), 2e-5 for fp32 and 5e-2 for
bf16 (both compute in fp32 and round once to bf16, so they may differ by
one bf16 ulp of an output of a few units).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as ref_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels import paged_attention
from repro_torch.kernels.paged_attention import paged_attention_plain

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(b, hq, hkv, d, npg, ps, maxp, dtype, seed=7, lengths=None,
            table=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((npg, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((npg, ps, hkv, d)).astype(np.float32)
    if table is None:
        table = rng.integers(0, npg, (b, maxp))
    if lengths is None:
        lengths = rng.integers(1, maxp * ps + 1, (b,))
    return (q, kp, vp, np.asarray(table, np.int32),
            np.asarray(lengths, np.int32), dtype)


def _port(q, kp, vp, pt, ln, dtype):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(dt) for x in (q, kp, vp)]
    args += [torch.from_numpy(pt), torch.from_numpy(ln)]
    return paged_attention(*args).float().numpy()


def _reference(q, kp, vp, pt, ln, dtype):
    dt = jnp.dtype(dtype)
    args = [jnp.asarray(x, dt) for x in (q, kp, vp)]
    args += [jnp.asarray(pt), jnp.asarray(ln)]
    return (np.asarray(ref_paged(*args).astype(jnp.float32)),
            np.asarray(paged_attention_ref(*args).astype(jnp.float32)))


def _check(inputs):
    got = _port(*inputs)
    kernel, oracle = _reference(*inputs)
    tol = TOL[inputs[-1]]
    assert got.shape == kernel.shape and np.all(np.isfinite(got))
    assert np.max(np.abs(got - kernel)) < tol
    assert np.max(np.abs(got - oracle)) < tol
    return got


# (b, hq, hkv, d, n_pages, page_size, max_pages, dtype)
CASES = {
    # the reference test's three cases (tests/test_kernels.py)
    "ref-gqa2": (2, 4, 2, 64, 16, 16, 4, "float32"),
    "ref-g8": (1, 8, 1, 128, 32, 32, 8, "float32"),
    "ref-bf16": (3, 4, 4, 64, 8, 16, 3, "bfloat16"),
    # groups that are not powers of two
    "g3": (2, 6, 2, 64, 12, 16, 5, "float32"),
    "g6-bf16": (2, 12, 2, 128, 12, 32, 4, "bfloat16"),
    # the serving shapes: qwen3 (G 2, D 128) and zamba2 (G 1, D 64)
    "qwen3": (1, 16, 8, 128, 16, 32, 16, "bfloat16"),
    "zamba2": (1, 32, 32, 64, 16, 32, 16, "float32"),
    # gemma3's head_dim 256: its decode shape (G 4 over 1 kv head), and G 8
    "gemma3": (1, 4, 1, 256, 16, 32, 16, "bfloat16"),
    "d256-g8": (2, 8, 1, 256, 12, 16, 5, "float32"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_paged_attention_matches_reference(case):
    _check(_inputs(*CASES[case]))


def test_repeated_page_ids():
    """Several page-table entries of one sequence, and of two sequences,
    name the same page."""
    table = [[3, 3, 1, 3], [1, 3, 0, 0]]
    _check(_inputs(2, 4, 2, 64, 4, 16, 4, "float32", lengths=[64, 50],
                   table=table))


def test_garbage_past_the_length():
    """Entries past a sequence's last page are never followed: random
    in-range ids agree with the reference, and ids no pool holds (-1,
    2**30) give the same result as any valid ones."""
    b, hq, hkv, d, npg, ps, maxp = 3, 4, 2, 64, 8, 16, 6
    lengths = [17, 1, 40]          # 2, 1 and 3 live pages
    table = np.random.default_rng(3).integers(0, npg, (b, maxp))
    want = _check(_inputs(b, hq, hkv, d, npg, ps, maxp, "float32",
                          lengths=lengths, table=table))
    for fill in (-1, 2 ** 30):
        bad = table.copy()
        for i, n in enumerate((2, 1, 3)):
            bad[i, n:] = fill
        got = _port(*_inputs(b, hq, hkv, d, npg, ps, maxp, "float32",
                             lengths=lengths, table=bad))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lengths_at_the_edges(dtype):
    """Lengths 0 (zeros, not NaN), 1, PS, PS+1, MAXP*PS, and past MAXP*PS
    (clamped to the table's pages, as the reference's grid and mask are)."""
    ps, maxp = 16, 4
    lengths = [0, 1, ps, ps + 1, maxp * ps, maxp * ps + 7]
    got = _check(_inputs(len(lengths), 6, 2, 64, 10, ps, maxp, dtype,
                         lengths=lengths))
    assert np.all(got[0] == 0.0)


def test_kernel_launch_count_and_bad_arguments():
    inputs = _inputs(2, 4, 2, 64, 4, 16, 2, "float32")
    before = paged_attention.launches
    _port(*inputs)
    assert paged_attention.launches == before     # CPU: the plain version
    q, kp, vp = (torch.from_numpy(x) for x in inputs[:3])
    pt, ln = torch.from_numpy(inputs[3]), torch.from_numpy(inputs[4])
    torch.testing.assert_close(paged_attention(q, kp, vp, pt, ln),
                               paged_attention_plain(q, kp, vp, pt, ln),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_attention(q[:, :3], kp, vp, pt, ln)          # 3 % 2 != 0
    with pytest.raises(ValueError, match="bad shapes"):
        paged_attention(q, kp, vp[:, :8], pt, ln)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_attention(q, kp, vp, pt[:1], ln)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_attention(q, kp, vp, pt, ln[:1])
    with pytest.raises(TypeError, match="one dtype"):
        paged_attention(q.double(), kp, vp, pt, ln)


# --------------------------------------------------------------------------
# The kernel's split over blocks (flash-decoding): the wrapper's plan, and a
# torch mirror of the split/combine arithmetic held against the plain
# version and the reference's oracle.

from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MIN_BLOCKS_PER_SM, RESIDENT_BLOCKS_PER_SM, TILE_TOKENS, split_plan)


def _ranges(capacity, n, per):
    return [(z * per, min((z + 1) * per, capacity)) for z in range(n)]


@pytest.mark.parametrize("capacity,b,hkv,n_sm,want", [
    (512, 1, 8, 132, (16, 32)),        # qwen3 decode: one tile per split
    (512, 1, 32, 132, (16, 32)),       # zamba2 decode
    (4096, 8, 8, 132, (8, 512)),       # long decode: 512 blocks, one wave
    (4096, 1, 8, 132, (64, 64)),       # B 1 x 4,096
    (4096, 64, 8, 132, (1, 4096)),     # 512 pairs fill the card: no split
    (0, 1, 1, 132, (1, 32)),           # MAXP 0: one empty split
    (100, 3, 2, 132, (4, 32)),         # capacity not a multiple of a tile
])
def test_split_plan(capacity, b, hkv, n_sm, want):
    n, per = split_plan(capacity, b, hkv, n_sm)
    assert (n, per) == want
    assert per % TILE_TOKENS == 0
    if capacity:
        spans = _ranges(capacity, n, per)
        assert spans[0][0] == 0 and spans[-1][1] == capacity
        assert all(lo < hi for lo, hi in spans)     # no split is empty
        assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))


def test_split_plan_covers_every_capacity():
    """Splits tile the capacity exactly, each a whole number of tiles, as
    short as the wanted count of splits allows (at least MIN_BLOCKS_PER_SM
    blocks per SM, or RESIDENT_BLOCKS_PER_SM if that is more), and never
    more of them than wanted."""
    rng = np.random.default_rng(5)
    for _ in range(400):
        capacity = int(rng.integers(1, 20000))
        b, hkv = int(rng.integers(1, 17)), int(rng.choice([1, 2, 8, 32]))
        n_sm = int(rng.choice([1, 8, 132]))
        n, per = split_plan(capacity, b, hkv, n_sm)
        tiles = -(-capacity // TILE_TOKENS)
        assert per % TILE_TOKENS == 0 and 1 <= n <= tiles
        assert (n - 1) * per < capacity <= n * per
        wanted = max(-(-MIN_BLOCKS_PER_SM * n_sm // (b * hkv)),
                     RESIDENT_BLOCKS_PER_SM * n_sm // (b * hkv), 1)
        assert per == -(-tiles // min(wanted, tiles)) * TILE_TOKENS
        assert n <= wanted


def _split_mirror(q, kp, vp, pt, ln, ns, per, scale=None, window=None,
                  return_lse=False):
    """The kernel's arithmetic in torch, fp32: each split's partial (m, l,
    unnormalised acc) over its own tokens (from the window's first token,
    ``max(0, length - window)``, if there is a window), an empty split (m
    -1e30, l 0), then the combine in split order.  Only page-table entries
    of live tokens are read.  With ``return_lse`` also each row's
    log-sum-exp as the combine stores it: mx + log(den), -1e30 where den
    is 0."""
    b, hq, d = q.shape
    _, ps, hkv, _ = kp.shape
    g = hq // hkv
    cap = pt.shape[1] * ps
    scale = scale if scale is not None else d ** -0.5
    out = torch.zeros((b, hq, d), dtype=torch.float32)
    lse = torch.zeros((b, hq), dtype=torch.float32)
    for bi in range(b):
        n_tok = max(0, min(int(ln[bi]), cap))
        first = max(0, int(ln[bi]) - window) if window else 0
        parts = []
        for z in range(ns):
            lo, hi = first + z * per, min(first + (z + 1) * per, n_tok)
            if lo >= hi:
                parts.append((torch.full((hq,), -1e30), torch.zeros(hq),
                              torch.zeros((hq, d))))
                continue
            tok = torch.arange(lo, hi)
            rows = pt[bi, tok // ps].long() * ps + tok % ps
            k = kp.reshape(-1, hkv, d)[rows].float()      # [t, hkv, d]
            v = vp.reshape(-1, hkv, d)[rows].float()
            s = torch.einsum("hgd,thd->hgt",
                             q[bi].float().reshape(hkv, g, d), k) * scale
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m.reshape(hq), p.sum(-1).reshape(hq),
                          torch.einsum("hgt,thd->hgd", p, v).reshape(hq, d)))
        mx = torch.full((hq,), -1e30)
        for m, l, _ in parts:
            mx = torch.where(l > 0, torch.maximum(mx, m), mx)
        num, den = torch.zeros((hq, d)), torch.zeros(hq)
        for m, l, acc in parts:                           # in split order
            w = torch.where(l > 0, torch.exp(m - mx), 0.0)
            num = num + w[:, None] * acc
            den = den + w * l
        out[bi] = num / torch.clamp(den, min=1e-30)[:, None]
        lse[bi] = torch.where(den > 0, mx + torch.log(den), -1e30)
    return (out, lse) if return_lse else out


@pytest.mark.parametrize("n_sm", [132, 8])
def test_split_combine_mirror(n_sm):
    """The split/combine arithmetic against the plain version and the
    reference's ref.py on numpy-seeded inputs: lengths 0, 1, split-1,
    split, split+1 and MAXP*PS, with repeated page ids and garbage ids
    (-1, 2**30) past each length.  Tolerance: the reference's fp32 2e-5."""
    hq, hkv, d, ps, maxp = 4, 2, 64, 16, 12
    cap = maxp * ps
    ns, per = split_plan(cap, 6, hkv, n_sm)
    assert ns > 1
    lengths = [0, 1, per - 1, per, per + 1, cap]
    rng = np.random.default_rng(11)
    npg = 5                                    # 12 slots over 5 pages
    table = rng.integers(0, npg, (len(lengths), maxp))
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = (-1, 2 ** 30)[i % 2]
    q, kp, vp, pt, ln, _ = _inputs(len(lengths), hq, hkv, d, npg, ps, maxp,
                                   "float32", lengths=lengths, table=table)
    tq, tk, tv, tpt, tln = (torch.from_numpy(x) for x in (q, kp, vp, pt, ln))
    got = _split_mirror(tq, tk, tv, tpt, tln, ns, per).numpy()
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))
    plain = paged_attention_plain(tq, tk, tv, tpt, tln).numpy()
    assert np.max(np.abs(got - plain)) < TOL["float32"]
    safe = np.where(table < 0, 0, np.where(table >= npg, 0, table))
    oracle = np.asarray(paged_attention_ref(
        *(jnp.asarray(x) for x in (q, kp, vp)), jnp.asarray(safe, jnp.int32),
        jnp.asarray(ln)).astype(jnp.float32))
    assert np.max(np.abs(got - oracle)) < TOL["float32"]


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("n_sm", [132, 8])
def test_split_combine_mirror_lse(n_sm, window):
    """The combine's log-sum-exp (``return_lse``, the sequence-sharded
    decode's input) against the plain version's, over the split mirror's
    lengths, with and without a window: within the fp32 2e-5, -1e30 for
    the empty row, the output the same with and without it."""
    hq, hkv, d, ps, maxp = 4, 2, 64, 16, 12
    cap = maxp * ps
    ns, per = split_plan(min(cap, window or cap), 6, hkv, n_sm)
    assert ns > 1
    lengths = [0, 1, per - 1, per, per + 1, cap]
    q, kp, vp, pt, ln, _ = _inputs(len(lengths), hq, hkv, d, 20, ps, maxp,
                                   "float32", lengths=lengths, seed=12)
    tq, tk, tv, tpt, tln = (torch.from_numpy(x) for x in (q, kp, vp, pt, ln))
    out, lse = _split_mirror(tq, tk, tv, tpt, tln, ns, per, window=window,
                             return_lse=True)
    p_out, p_lse = paged_attention_plain(tq, tk, tv, tpt, tln, window=window,
                                         return_lse=True)
    assert torch.equal(p_out, paged_attention_plain(tq, tk, tv, tpt, tln,
                                                    window=window))
    assert torch.all(lse[0] == -1e30) and torch.all(p_lse[0] == -1e30)
    assert float((lse - p_lse).abs().max()) < TOL["float32"]
    assert float((out - p_out).abs().max()) < TOL["float32"]


# --------------------------------------------------------------------------
# Sliding windows (gemma3's local layers): the plain version against the
# reference's own decode attention, ``attention._sdpa(..., window=w,
# q_offset=pos)`` over each sequence's gathered K/V, with garbage before the
# window; the split plan over the window's span; the split mirror with a
# window.

from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    RESIDENT_BLOCKS_D256)


def _sdpa_reference(q, kp, vp, table, lengths, window):
    """The reference's ``_sdpa`` for one query at position length - 1 per
    sequence, over its pages gathered in table order (fp32)."""
    b, hq, d = q.shape
    _, ps, hkv, _ = kp.shape
    out = np.zeros((b, hq, d), np.float32)
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        pages = table[i, :-(-n // ps)]
        k = kp[pages].reshape(1, -1, hkv, d)
        v = vp[pages].reshape(1, -1, hkv, d)
        o = ref_attention._sdpa(jnp.asarray(q[i][None, None]), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                window=jnp.int32(window), q_offset=n - 1)
        out[i] = np.asarray(o)[0, 0]
    return out


@pytest.mark.parametrize("window", [1, 15, 16, 17, 40, 10 ** 6])
@pytest.mark.parametrize("d", [64, 256])
def test_window_matches_reference_sdpa(window, d):
    """Lengths at the page (16) and window edges, a window past the length
    (global) and the table's capacity; then every row before each window
    (the rest of its first live page and every page wholly before it) set
    to NaN and those pages' table entries to -1 or 2**30: the output must
    not change, so nothing before the window is read."""
    hq, hkv, ps, maxp = 4, 1, 16, 6
    lengths = sorted({0, 1, 15, 16, 17, window - 1, window, window + 1,
                      window + 15, window + 16, 33, maxp * ps} &
                     set(range(maxp * ps + 1)))
    b = len(lengths)
    rng = np.random.default_rng(window + d)
    table = rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)
    q, kp, vp, _, ln, _ = _inputs(b, hq, hkv, d, b * maxp, ps, maxp,
                                  "float32", lengths=lengths, table=table)
    want = _sdpa_reference(q, kp, vp, table, lengths, window)
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, ln)]
    got = paged_attention(*args, window=window).numpy()
    assert np.max(np.abs(got - want)) < TOL["float32"]
    bad_k, bad_v, bad_t = kp.copy(), vp.copy(), table.copy()
    for i, n in enumerate(lengths):
        lo = max(0, n - window)
        for x in (bad_k, bad_v):
            x[table[i, :lo // ps]] = np.nan
            if lo % ps:
                x[table[i, lo // ps], :lo % ps] = np.nan
        bad_t[i, :lo // ps] = (-1, 2 ** 30)[i % 2]
        bad_t[i, -(-n // ps):] = (-1, 2 ** 30)[i % 2]
    poisoned = paged_attention(
        *(torch.from_numpy(x) for x in (q, bad_k, bad_v, bad_t, ln)),
        window=window).numpy()
    np.testing.assert_array_equal(poisoned, got)


def test_window_of_minus_one_or_none_is_global():
    inputs = _inputs(3, 4, 2, 64, 8, 16, 4, "float32", lengths=[5, 40, 64])
    args = [torch.from_numpy(x) for x in inputs[:5]]
    want = paged_attention(*args)
    for w in (None, -1, 0):
        np.testing.assert_array_equal(paged_attention(*args, window=w), want)
    assert not torch.equal(paged_attention(*args, window=8), want)


def test_split_plan_follows_window_and_head_dim():
    """The wrapper plans over the window's span, not the capacity, and at
    head_dim 256 with the blocks that fit an SM there; the D 64/128 plans
    are those of the default."""
    n_sm = 132
    # gemma3's decode: a 512-token window over a 4,096-token table plans as
    # a 512-token table does
    assert split_plan(512, 1, 1, n_sm, RESIDENT_BLOCKS_D256[torch.bfloat16]) \
        == (16, 32)
    assert split_plan(4096, 1, 1, n_sm,
                      RESIDENT_BLOCKS_D256[torch.bfloat16]) == (128, 32)
    assert split_plan(4096, 8, 8, n_sm) == \
        split_plan(4096, 8, 8, n_sm, RESIDENT_BLOCKS_PER_SM) == (8, 512)
    # fewer resident blocks, fewer splits once the grid fills the card
    assert split_plan(4096, 8, 8, n_sm, 1) == (5, 832)
    assert RESIDENT_BLOCKS_D256 == {torch.bfloat16: 2, torch.float32: 1}


@pytest.mark.parametrize("window", [1, 16, 40])
def test_split_combine_mirror_window(window):
    """The split/combine arithmetic with a window: splits cover [lo, lo +
    ns * per) with lo = max(0, length - window), planned over the window's
    span; against the plain version (fp32 2e-5)."""
    hq, hkv, d, ps, maxp = 4, 1, 256, 16, 12
    cap = maxp * ps
    ns, per = split_plan(min(cap, window), 6, hkv, 132, 1)
    lengths = [0, 1, window, window + 1, window + per + 3, cap]
    table = np.random.default_rng(window).permutation(6 * maxp).reshape(
        6, maxp)
    q, kp, vp, pt, ln, _ = _inputs(6, hq, hkv, d, 6 * maxp, ps, maxp,
                                   "float32", lengths=lengths, table=table)
    tq, tk, tv, tpt, tln = (torch.from_numpy(x) for x in (q, kp, vp, pt, ln))
    got = _split_mirror(tq, tk, tv, tpt, tln, ns, per, window=window).numpy()
    plain = paged_attention_plain(tq, tk, tv, tpt, tln,
                                  window=window).numpy()
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))
    assert np.max(np.abs(got - plain)) < TOL["float32"]
