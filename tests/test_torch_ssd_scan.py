"""Port of the ssd_scan kernel against the JAX reference on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernel
(interpret mode on the CPU), its sequential oracle ``ssd_scan_ref`` and the
port's wrapper, which runs the plain chunked version for CPU tensors and
pads L exactly as the reference's wrapper does.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-4 in float32 (a chunked sum
in another order than the recurrence) and 6e-2 in bfloat16 (bf16 inputs and
output rounding).  bf16 inputs are rounded once, in JAX, and handed to
torch exactly through float32.

The port's scan also returns the final state, which the reference's
wrapper does not: it is held to a float64 run of the recurrence
``s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T`` on the same (rounded)
inputs, within 2e-4 in both dtypes, since the state is float32 arithmetic
and is never rounded to bf16.

The CUDA kernel cannot run here, so :func:`_three_pass` mirrors its
arithmetic in torch: unpadded 64-step chunks, each chunk's own end state
and decay, the carried states across chunks, then y from the carried
state and the masked intra-chunk products.  It reads strided inputs cut
from one ``xbc``-shaped buffer as the model cuts them, as the kernel does,
and is held to the plain version and the reference at the tolerances
above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.kernels.ssd_scan.ops import _KERNEL_CK, _rows_aligned

CASES = [  # b, L, h, g, p, n, ck, dtype
    (1, 128, 2, 1, 64, 64, 64, "float32"),
    (2, 256, 4, 2, 32, 16, 128, "float32"),
    (1, 200, 2, 1, 64, 32, 64, "float32"),
    (1, 128, 2, 1, 64, 64, 64, "bfloat16"),
    (1, 300, 4, 2, 32, 16, 128, "float32"),     # padded to 384
    (2, 100, 2, 1, 32, 16, 128, "float32"),     # one chunk of 100
]
TOL = {"float32": 2e-4, "bfloat16": 6e-2}


def _inputs(b, L, h, g, p, n, dtype, dt_scale=0.1, dt_floor=0.01, seed=4):
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((b, L, h, p)), dt)
    dts = jnp.asarray(np.abs(rng.standard_normal((b, L, h))) * dt_scale
                      + dt_floor, dt)
    a = jnp.asarray(-np.abs(rng.standard_normal(h)) - 0.1, jnp.float32)
    bb = jnp.asarray(rng.standard_normal((b, L, g, n)) * 0.3, dt)
    cc = jnp.asarray(rng.standard_normal((b, L, g, n)) * 0.3, dt)
    tt = getattr(torch, dtype)
    port = [torch.from_numpy(np.array(t.astype(jnp.float32))).to(tt)
            for t in (x, dts, a, bb, cc)]
    port[2] = torch.from_numpy(np.array(a))       # a stays float32
    return (x, dts, a, bb, cc), port


def _oracle(x, dts, a, bb, cc):
    b, L, h, p = x.shape
    rep = h // bb.shape[2]
    bf = jnp.repeat(bb, rep, axis=2)
    cf = jnp.repeat(cc, rep, axis=2)
    n = bf.shape[-1]
    return ssd_scan_ref(
        x.transpose(0, 2, 1, 3).reshape(b * h, L, p),
        dts.transpose(0, 2, 1).reshape(b * h, L), jnp.tile(a, b),
        bf.transpose(0, 2, 1, 3).reshape(b * h, L, n),
        cf.transpose(0, 2, 1, 3).reshape(b * h, L, n),
    ).reshape(b, h, L, p).transpose(0, 2, 1, 3)


def _state_oracle(x, dts, a, bb) -> np.ndarray:
    """[B, H, N, P]: the recurrence step by step in float64."""
    x, dts, a, bb = (np.asarray(t.astype(jnp.float32), np.float64)
                     for t in (x, dts, a, bb))
    b, L, h, p = x.shape
    bf = np.repeat(bb, h // bb.shape[2], axis=2)
    s = np.zeros((b, h, bf.shape[-1], p))
    for t in range(L):
        s = (np.exp(dts[:, t] * a)[..., None, None] * s
             + dts[:, t, :, None, None] * bf[:, t, :, :, None]
             * x[:, t, :, None, :])
    return s


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want.astype(jnp.float32)))))


@pytest.mark.parametrize("b,L,h,g,p,n,ck,dtype", CASES)
def test_ssd_matches_reference(b, L, h, g, p, n, ck, dtype):
    ref_in, port_in = _inputs(b, L, h, g, p, n, dtype)
    launches = ssd_scan.launches
    got, state = ssd_scan(*port_in, ck=ck)
    assert ssd_scan.launches == launches          # CPU: plain version only
    assert got.dtype == port_in[0].dtype and got.shape == port_in[0].shape
    assert _err(got, ref_ssd(*ref_in, ck=ck)) < TOL[dtype]
    assert _err(got, _oracle(*ref_in)) < TOL[dtype]
    assert state.dtype == torch.float32 and state.shape == (b, h, n, p)
    assert _err(state, _state_oracle(*ref_in[:4])) < 2e-4


@pytest.mark.parametrize("L", [1, 2, 129])
def test_ssd_short_and_large_dt(L):
    """dt from 1e-4 to 10: every exp() the plain version evaluates has a
    non-positive argument (pairs j > t are never exponentiated), so the
    output stays finite and matches the sequential oracle."""
    ref_in, port_in = _inputs(1, L, 4, 2, 32, 16, "float32", dt_scale=5.0,
                              dt_floor=1e-4, seed=L)
    got, state = ssd_scan_plain(*port_in)
    assert torch.isfinite(got).all()
    assert _err(got, _oracle(*ref_in)) < 2e-4
    assert _err(state, _state_oracle(*ref_in[:4])) < 2e-4


def test_ssd_rejects_bad_shapes():
    x = torch.zeros(1, 8, 3, 4)
    with pytest.raises(ValueError):        # 3 heads over 2 groups
        ssd_scan(x, torch.zeros(1, 8, 3), torch.zeros(3),
                 torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2, 4))


@pytest.mark.parametrize("L,ck", [(128, 64), (189, 128), (300, 128)])
def test_state_dt_keeps_y_and_takes_fp32_dt(L, ck):
    """bf16 x, B, C with y's dt rounded to bf16 (the reference's Pallas
    route) and the state's dt in fp32: y is bit for bit y without ``state_dt``
    (and the reference kernel's), while the state is the float64
    recurrence's with the fp32 dt, within 2e-4 as above; from y's bf16 dt
    it would be off by ~2^-9 of dt."""
    ref_in, port_in = _inputs(1, L, 4, 2, 32, 16, "bfloat16", seed=L)
    rng = np.random.default_rng(L)
    dt32 = np.abs(rng.standard_normal((1, L, 4))).astype(np.float32) * 0.5
    dt16 = jnp.asarray(dt32, jnp.bfloat16)
    state_dt = torch.from_numpy(dt32)
    x, _, a, bm, cm = port_in
    dt = torch.from_numpy(np.array(dt16.astype(jnp.float32))).to(
        torch.bfloat16)
    y0, state0 = ssd_scan(x, dt, a, bm, cm, ck=ck)
    y, state = ssd_scan(x, dt, a, bm, cm, ck=ck, state_dt=state_dt)
    assert torch.equal(y, y0)
    ref = (ref_in[0], dt16, ref_in[2], ref_in[3], ref_in[4])
    assert _err(y, ref_ssd(*ref, ck=ck)) < TOL["bfloat16"]
    want = _state_oracle(ref[0], jnp.asarray(dt32), ref[2], ref[3])
    assert _err(state, want) < 2e-4
    assert _err(state0, want) > 10 * _err(state, want)
    with pytest.raises(ValueError):         # the state's dt is float32
        ssd_scan(x, dt, a, bm, cm, state_dt=dt)


def _three_pass(x, dt, a, bm, cm, q=_KERNEL_CK):
    """The kernel's three passes (``csrc/ssd_scan.cu``) in fp32 torch on
    unpadded inputs: (y in x's dtype, final state [B, H, N, P])."""
    bsz, L, h, p = x.shape
    rep = h // bm.shape[2]
    xf, dtf = x.float(), dt.float()
    bf = bm.float().repeat_interleave(rep, 2)           # [B, L, H, N]
    cf = cm.float().repeat_interleave(rep, 2)
    spans = [slice(c0, min(L, c0 + q)) for c0 in range(0, L, q)]
    own, last, cums = [], [], []
    for sl in spans:                                    # chunk_state
        acs = a * torch.cumsum(dtf[:, sl], 1)           # [B, T, H]
        w = torch.exp(acs[:, -1:] - acs) * dtf[:, sl]
        own.append(torch.einsum("bth,bthn,bthp->bhnp", w, bf[:, sl],
                                xf[:, sl]))
        last.append(acs[:, -1])
        cums.append(acs)
    s_in = [torch.zeros_like(own[0])]                   # state_pass
    for s_own, a_last in zip(own, last):
        s_in.append(torch.exp(a_last)[..., None, None] * s_in[-1] + s_own)
    ys = []
    for sl, acs, s in zip(spans, cums, s_in):           # chunk_out
        at = acs.transpose(1, 2)                        # [B, H, T]
        t = at.shape[-1]
        tril = torch.ones(t, t, dtype=torch.bool).tril()
        diff = at[..., :, None] - at[..., None, :]
        decay = torch.exp(torch.where(tril, diff, float("-inf")))
        w = (torch.einsum("bthn,bjhn->bhtj", cf[:, sl], bf[:, sl]) * decay
             * dtf[:, sl].transpose(1, 2)[..., None, :])
        ys.append(torch.exp(acs)[..., None]
                  * torch.einsum("bthn,bhnp->bthp", cf[:, sl], s)
                  + torch.einsum("bhtj,bjhp->bthp", w, xf[:, sl]))
    return torch.cat(ys, 1).to(x.dtype), s_in[-1]


def _xbc_inputs(b, L, h, g, p, n, dtype, wide_dt, seed):
    """One [B, L, H*P + 2*G*N] buffer cut into x, B and C the way
    ``models/ssd.py`` cuts ``xbc`` (strided views), with dt [B, L, H] and
    a [H]; the same values, contiguous, for the reference."""
    rng = np.random.default_rng(seed)
    di = h * p
    jd = jnp.dtype(dtype)
    xbc = np.concatenate([rng.standard_normal((b, L, di)),
                          rng.standard_normal((b, L, 2 * g * n)) * 0.3], -1)
    xbc = np.array(jnp.asarray(xbc, jd).astype(jnp.float32))
    if wide_dt:                           # log-uniform from 1e-4 to 10
        dts = 10.0 ** rng.uniform(-4, 1, (b, L, h))
    else:
        dts = np.abs(rng.standard_normal((b, L, h))) * 0.1 + 0.01
    dts = np.array(jnp.asarray(dts, jd).astype(jnp.float32))
    a = (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32)
    tt = getattr(torch, dtype)
    buf = torch.from_numpy(xbc).to(tt)
    port = (buf[..., :di].reshape(b, L, h, p),
            torch.from_numpy(dts).to(tt), torch.from_numpy(a),
            buf[..., di:di + g * n].reshape(b, L, g, n),
            buf[..., di + g * n:].reshape(b, L, g, n))
    ref = (jnp.asarray(xbc[..., :di].reshape(b, L, h, p), jd),
           jnp.asarray(dts, jd), jnp.asarray(a),
           jnp.asarray(xbc[..., di:di + g * n].reshape(b, L, g, n), jd),
           jnp.asarray(xbc[..., di + g * n:].reshape(b, L, g, n), jd))
    return ref, port


@pytest.mark.parametrize("L", [1, 63, 64, 65, 189, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wide_dt", [False, True])
def test_three_pass_mirror(L, dtype, wide_dt):
    """The kernel's passes on unpadded, strided inputs (H 4 over G 2)
    against the plain version (padded as the reference pads), the
    reference's sequential oracle and, for dt in the softplus range, its
    Pallas kernel in interpret mode; dt log-uniform from 1e-4 to 10
    overflows that kernel's unmasked exponentials, so there only the
    oracle and the plain version stand.  The state is held to a float64
    run of the recurrence."""
    b, h, g, p, n = 2, 4, 2, 32, 16
    ref_in, port_in = _xbc_inputs(b, L, h, g, p, n, dtype, wide_dt, L)
    assert not port_in[0].is_contiguous() and not port_in[3].is_contiguous()
    got, state = _three_pass(*port_in)
    assert got.dtype == port_in[0].dtype and got.shape == port_in[0].shape
    plain, plain_state = ssd_scan_plain(*port_in)
    assert _err(got, jnp.asarray(plain.float().numpy())) < TOL[dtype]
    assert _err(got, _oracle(*ref_in)) < TOL[dtype]
    if not wide_dt:
        assert _err(got, ref_ssd(*ref_in)) < TOL[dtype]
    assert state.shape == (b, h, n, p)
    assert _err(state, jnp.asarray(plain_state.numpy())) < 2e-4
    assert _err(state, _state_oracle(*ref_in[:4])) < 2e-4


def test_rows_aligned_keeps_model_views():
    """The card path passes the model's views of xbc through uncopied and
    copies only what its 16-byte cp.async rows cannot read."""
    _, (x, _, _, bm, cm) = _xbc_inputs(1, 70, 4, 1, 64, 64, "bfloat16",
                                       False, 0)
    for t in (x, bm, cm):
        assert _rows_aligned(t, 8) is t
    odd = torch.zeros(1, 70, 4 * 64 + 1, dtype=torch.bfloat16)
    view = odd[..., 1:].reshape(1, 70, 4, 64)    # rows off by 2 bytes
    fixed = _rows_aligned(view, 8)
    assert fixed is not view and fixed.is_contiguous()
    assert torch.equal(fixed, view)


@pytest.mark.parametrize("L", [65, 189])
def test_fp32_dt_with_bf16_inputs(L):
    """bf16 x, B and C with fp32 dt (``models/ssd.py``'s call, the
    reference's default route): ``ssd_scan`` takes it, its y is the plain
    version's bit for bit and the reference oracle's with that fp32 dt
    within the bf16 tolerance, as is the kernel's three-pass mirror; the
    final state from ``state_dt=dt`` is the float64 recurrence's within
    2e-4.  y from dt rounded to bf16 is another function of the inputs."""
    b, h, g, p, n = 2, 4, 2, 32, 16
    ref_in, port_in = _xbc_inputs(b, L, h, g, p, n, "bfloat16", False, L)
    x, _, a, bm, cm = port_in
    dt32 = np.abs(np.random.default_rng(L).standard_normal(
        (b, L, h))).astype(np.float32) * 0.5
    dt = torch.from_numpy(dt32)
    y, state = ssd_scan(x, dt, a, bm, cm, state_dt=dt)
    plain, plain_state = ssd_scan_plain(x, dt, a, bm, cm, state_dt=dt)
    assert y.dtype == torch.bfloat16 and torch.equal(y, plain)
    assert torch.equal(state, plain_state)
    ref = (ref_in[0], jnp.asarray(dt32), ref_in[2], ref_in[3], ref_in[4])
    assert _err(y, _oracle(*ref)) < TOL["bfloat16"]
    mirror, mirror_state = _three_pass(x, dt, a, bm, cm)
    assert _err(mirror, jnp.asarray(plain.float().numpy())) < TOL["bfloat16"]
    want = _state_oracle(*ref[:4])
    assert _err(state, want) < 2e-4 and _err(mirror_state, want) < 2e-4
    y16, _ = ssd_scan(x, dt.to(torch.bfloat16), a, bm, cm)
    assert not torch.equal(y16, y)
