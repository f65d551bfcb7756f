"""flash_attention's gradient in the port against torch.autograd and the
JAX reference on the CPU.

The port's attention goes through ``kernels.flash_attention`` on every
path, so its training runs that wrapper's ``autograd.Function``: on a CUDA
tensor the backward launches the hand-written kernel
(``csrc/flash_attention_bwd.cu``), on a CPU tensor it runs
``flash_attention_bwd_plain``, the explicit formulas from the forward's
log-sum-exp.  The reference has no backward kernel: it differentiates its
plain attention (``repro.models.attention._sdpa``) with ``jax.grad``.  The
same numpy-seeded q, k, v and output cotangent go to both.

Tolerance (float32): ``max|Δ| <= 2e-5 * max(1, max|ref|)`` per gradient —
sums of up to 8 heads x 200 queries of products taken in another order,
and P recomputed from the log-sum-exp rather than by a softmax (measured
below 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.attention import _sdpa as ref_sdpa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

TOL = 2e-5
CASES = [  # b, hq, hkv, sq, sk, d, causal, window
    (1, 2, 2, 64, 64, 64, True, None),
    (2, 4, 2, 65, 65, 64, True, None),           # GQA 2, ragged
    (1, 8, 1, 40, 40, 128, True, None),          # GQA 8
    (1, 4, 1, 50, 50, 256, True, 16),            # gemma3's D 256, window
    (1, 2, 1, 33, 33, 64, True, 1),              # window 1: the diagonal
    (2, 6, 6, 9, 70, 64, False, None),           # whisper's cross: Sq != Sk
    (1, 4, 2, 17, 3, 128, False, None),
    (1, 2, 2, 1, 1, 256, False, None),
]


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, hq, sq, d))]


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), (what, err)


def _port_grads(q, k, v, do, causal, window):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window)
    return out, torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,win", CASES)
def test_bwd_plain_matches_autograd_of_plain(b, hq, hkv, sq, sk, d, causal,
                                              win):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(b, hq, hkv, sq, sk, d))
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_plain(qr, kr, vr, causal=causal, window=win,
                                     return_lse=True)
    want = torch.autograd.grad(out, (qr, kr, vr), do)
    got = flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), do,
                                    causal=causal, window=win)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,win", CASES)
def test_bwd_matches_jax_grad_of_reference(b, hq, hkv, sq, sk, d, causal,
                                           win):
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d, seed=1)
    # the reference's layout: [B, S, H, D]
    t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))   # noqa: E731

    @jax.jit
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: ref_sdpa(
            q, k, v, causal=causal,
            window=jnp.int32(-1 if win is None else win)), q, k, v)
        return out, vjp(do)
    out, grads = out_and_grads(t(q), t(k), t(v), t(do))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]
    got_out, got = _port_grads(q, k, v, do, causal, win)
    _close(got_out, np.asarray(out).transpose(0, 2, 1, 3), "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


def test_bwd_wrapper_counts_nothing_on_the_cpu():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 8, 8, 64))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _port_grads(*(x.numpy() for x in (q, k, v, do)), True, None)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_bwd_under_checkpoint_equals_without():
    """torch.utils.checkpoint (the port's remat) runs the flash forward
    again in the backward pass and gives the same gradients."""
    q, k, v, do = _inputs(2, 4, 2, 30, 30, 64, seed=2)

    def grads(remat: bool):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]

        def f(q, k, v):
            return flash_attention(q, k, v, causal=True, window=8) * 2.0
        out = (checkpoint(f, *leaves, use_reentrant=False) if remat
               else f(*leaves))
        return torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(grads(True), grads(False)):
        assert torch.equal(g, w)


def test_bwd_bf16_rounds_fp32_grads_once():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 20, 20, 64))
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    bf = [x.bfloat16() for x in (q, k, v, out, do)]
    got = flash_attention_bwd_plain(*bf[:3], bf[3], lse, bf[4])
    want = flash_attention_bwd_plain(*(x.float() for x in bf[:4]), lse,
                                     bf[4].float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.bfloat16())


def test_bwd_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="as many keys"):
        flash_attention(x, x[:, :, :3], x[:, :, :3])
    with pytest.raises(ValueError, match="as many keys"):
        flash_attention(x, x[:, :, :3], x[:, :, :3], causal=False, window=2)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_bwd(x, x, x, x, lse[:, :, :3], x)


# The card's bf16 backward runs its five products as wgmmas at every
# head_dim: bf16 operands, fp32 accumulation, and the fp32 P and dS split
# into bf16 hi + lo halves before dV, dK and dQ.  At head_dim 256 the dK
# and dV kernel splits its work over two warpgroups: one forms P^T and
# hands it, in fp32, to the other, which forms dS^T = P^T * (dP^T -
# delta); the products and splits are those of head_dim 64 and 128.
# _wgmma_mirror repeats that arithmetic in torch; it is held to the plain
# version at the card's bf16 TOL for the backward (chip_smoke.py): |got -
# want| <= 1e-3 + 1e-2 * |want| element by element, since both sides
# accumulate in fp32 and round once to bf16.
BF16_TOL = (1e-3, 1e-2)
MIRROR_CASES = [  # b, hq, hkv, sq, sk, d, causal, window
    (1, 4, 2, 64, 64, 128, True, None),
    (1, 4, 2, 1024, 1024, 128, True, None),
    (1, 6, 6, 64, 1500, 64, False, None),  # whisper's cross attention
    (1, 4, 1, 64, 64, 256, True, None),    # gemma3's heads, training S
    (1, 4, 1, 600, 600, 256, True, 512),   # gemma3's local layer
]


def _wgmma_mirror(q, k, v, o, lse, do, causal, split=True, window=None):
    """(dq, dk, dv) in bf16 by the wgmma kernels' arithmetic: P = 2^(S *
    scale * log2 e - lse * log2 e) under the mask (causal, ``window``),
    delta = rowsum(dO * O), dS = P * (dP - delta), and P and dS as bf16
    hi + lo parts in the products that take them (``split=False``:
    rounded once to bf16)."""
    from repro_torch.kernels.flash_attention.ops import _mask
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale, log2e = d ** -0.5, 1.4426950408889634
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.where(mask, torch.exp2(s * (scale * log2e)
                                     - (lse * log2e)[..., None]), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)
    dv = sum(torch.einsum("bhqk,bhqd->bhkd", t, dof) for t in parts(p))
    dk = sum(torch.einsum("bhqk,bhqd->bhkd", t, qf) for t in parts(ds))
    dq = sum(torch.einsum("bhqk,bhkd->bhqd", t, kf) for t in parts(ds))
    dk = (dk * scale).reshape(b, hkv, rep, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, rep, sk, d).sum(dim=2)
    return (dq * scale).bfloat16(), dk.bfloat16(), dv.bfloat16()


def _bf16_case(b, hq, hkv, sq, sk, d, causal, seed, window=None):
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in
                   _inputs(b, hq, hkv, sq, sk, d, seed))
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    return q, k, v, o, lse, do


def _outside_tol(got, want) -> int:
    atol, rtol = BF16_TOL
    g, w = got.float(), want.float()
    return int(((g - w).abs() > atol + rtol * w.abs()).sum())


@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,win", MIRROR_CASES,
    ids=["-".join(map(str, c[:7])) + (f"-w{c[7]}" if c[7] else "")
         for c in MIRROR_CASES])
def test_wgmma_mirror_meets_the_bf16_tol(b, hq, hkv, sq, sk, d, causal,
                                         win):
    args = _bf16_case(b, hq, hkv, sq, sk, d, causal, seed=sq, window=win)
    want = flash_attention_bwd_plain(*args, causal=causal, window=win)
    got = _wgmma_mirror(*args, causal, window=win)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(g.float().isfinite().all()), name
        assert _outside_tol(g, w) == 0, name


def test_one_bf16_rounding_of_p_and_ds_misses_the_tol():
    """Why the kernel splits P and dS: rounded once to bf16, they leave
    elements of every gradient outside the TOL at S 64, D 128."""
    args = _bf16_case(1, 4, 2, 64, 64, 128, True, seed=64)
    want = flash_attention_bwd_plain(*args, causal=True)
    got = _wgmma_mirror(*args, True, split=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _outside_tol(g, w) > 0, name


@pytest.mark.parametrize("sq,win", [(64, None), (600, 512)])
def test_one_bf16_rounding_misses_the_tol_at_head_dim_256(sq, win):
    """The same at gemma3's heads (4 over 1 of 256): its training shape
    and a local layer past its 512-token window."""
    args = _bf16_case(1, 4, 1, sq, sq, 256, True, seed=sq, window=win)
    want = flash_attention_bwd_plain(*args, causal=True, window=win)
    got = _wgmma_mirror(*args, True, split=False, window=win)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _outside_tol(g, w) > 0, name
