"""ssd_scan's gradient in the port against the JAX reference on the CPU.

The reference trains the ssm block through ``jax.grad`` of its sequential
scan ``ssd_scan_ref`` (``repro/kernels/ssd_scan/ref.py``): it has no
backward kernel.  The port's ``ssd_scan_bwd_plain`` writes the adjoint
recurrence out in plain torch in the forward's chunks; it is held here to
``jax.grad`` through the reference wrapper's layout (B and C repeated over
each group's heads, a tiled over the batch, so their gradients come back
summed), within 2e-5 of each gradient's largest |element|, as
``tests/test_torch_training.py`` holds gradient leaves (fp32 sums in
another order; dt log-uniform from 1e-4 to 10, whose cumulative decays
carry the rounding of the chunks' cumsums), and to ``torch.autograd`` of
``ssd_scan_plain`` (the same chunks, another formulation: d(dt) there
goes through every exp(a_cs_t - a_cs_j)) within 4e-5, twice that, since
each of the two carries its own fp32 error and da, a sum over every
step, the most.

The CUDA kernel cannot run here, so :func:`_bwd_passes` mirrors its
arithmetic in torch, fp32 for its fp32 route and, for its bf16 route,
the tensor cores' products (bf16 x bf16 exact in fp32, each fp32 operand
split into bf16 hi + lo parts, ``SPLIT``; rounded once instead, each of
them leaves elements outside the tolerance): unpadded 64-step chunks;
per chunk and head its own end state and its own adjoint ``sum_t
exp(a_cs_t) C_t dy_t^T``; both carried across the chunks, the states
forward and the adjoint in reverse;
then per chunk dC, dB and dx from the chunk's entry state, the adjoint
carried in and the masked ``[64, 64]`` products, and d(dt) from
``dlog_t = lam_t <G_t, s_{t-1}>`` as four sums of products that form no
per-step state: ``sum_{tau >= t} exp(a_cs_tau) C_tau^T S_in dy_tau``,
``exp(a_last) <G_out, S_in>``, ``sum_{j < t} exp(a_last - a_cs_j) dt_j
B_j^T G_out x_j`` and the rectangle ``sum_{tau >= t > j} exp(a_cs_tau -
a_cs_j) dt_j (C_tau . B_j)(dy_tau . x_j)``, each of whose terms is exact
zero where the state is (the first step); dB and dC summed over each
group's heads, da over the batch and the chunks.  It reads strided views
cut from one ``xbc``-shaped buffer, as the model hands them over, and is
held to the plain version at the card's tolerance for the kernel
(``chip_smoke.py``, ``TOL_BWD``): ``|got - want| <= atol * max|want| +
rtol * |want|`` with (2e-4, 1e-4) in float32 and (1e-3, 1e-2) in
bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_plain, ssd_scan_plain)
from repro_torch.kernels.ssd_scan.ops import _KERNEL_CK, _bwd_kernel_check

NAMES = ("dx", "ddt", "da", "db", "dc")
TOL_BWD = {"float32": (2e-4, 1e-4), "bfloat16": (1e-3, 1e-2)}


def _inputs(b, L, h, g, p, n, seed, dtype="float32", strided=False):
    """(x, dt, a, B, C, dy) as float32 numpy (bf16 values rounded once) and
    as torch tensors of ``dtype`` (dt and a float32); dt log-uniform from
    1e-4 to 10.  ``strided``: x, B and C are views of one
    [B, L, H*P + 2*G*N] buffer, as ``models/ssd.py`` cuts ``xbc``."""
    rng = np.random.default_rng(seed)
    di = h * p
    xbc = np.concatenate([rng.standard_normal((b, L, di)),
                          rng.standard_normal((b, L, 2 * g * n)) * 0.3], -1)
    dts = 10.0 ** rng.uniform(-4, 1, (b, L, h))
    a = -np.abs(rng.standard_normal(h)) - 0.1
    dy = rng.standard_normal((b, L, h, p))
    jd = jnp.dtype(dtype)
    xbc, dy = (np.array(jnp.asarray(t, jd).astype(jnp.float32))
               for t in (xbc, dy))
    dts, a = dts.astype(np.float32), a.astype(np.float32)
    cut = (xbc[..., :di].reshape(b, L, h, p),
           xbc[..., di:di + g * n].reshape(b, L, g, n),
           xbc[..., di + g * n:].reshape(b, L, g, n))
    ref = (cut[0], dts, a, cut[1], cut[2], dy)
    tt = getattr(torch, dtype)
    if strided:
        buf = torch.from_numpy(xbc).to(tt)
        x = buf[..., :di].reshape(b, L, h, p)
        bm = buf[..., di:di + g * n].reshape(b, L, g, n)
        cm = buf[..., di + g * n:].reshape(b, L, g, n)
    else:
        x, bm, cm = (torch.from_numpy(np.ascontiguousarray(t)).to(tt)
                     for t in cut)
    port = (x, torch.from_numpy(dts), torch.from_numpy(a), bm, cm,
            torch.from_numpy(dy).to(tt))
    return ref, port


def _ref_y(x, dt, a, b, c):
    """The reference's sequential scan in its wrapper's layout."""
    bsz, L, h, p = x.shape
    rep = h // b.shape[2]
    bf = jnp.repeat(b, rep, axis=2)
    cf = jnp.repeat(c, rep, axis=2)
    n = bf.shape[-1]
    y = ssd_scan_ref(
        x.transpose(0, 2, 1, 3).reshape(bsz * h, L, p),
        dt.transpose(0, 2, 1).reshape(bsz * h, L), jnp.tile(a, bsz),
        bf.transpose(0, 2, 1, 3).reshape(bsz * h, L, n),
        cf.transpose(0, 2, 1, 3).reshape(bsz * h, L, n))
    return y.reshape(bsz, h, L, p).transpose(0, 2, 1, 3)


def _ref_grads(x, dt, a, b, c, dy):
    return jax.grad(lambda *t: jnp.sum(_ref_y(*t) * dy),
                    argnums=(0, 1, 2, 3, 4))(x, dt, a, b, c)


def _rel_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want| (0 when both are all zero)."""
    w = np.asarray(want, np.float64)
    err = float(np.max(np.abs(got.double().numpy() - w), initial=0.0))
    return err / max(float(np.max(np.abs(w), initial=0.0)), 1e-30) \
        if err else 0.0


@pytest.mark.parametrize("L", [1, 63, 64, 65, 189, 300])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_matches_jax_grad(L, g):
    ref, port = _inputs(2, L, 4, g, 32, 16, seed=L + 7 * g)
    want = _ref_grads(*ref)
    launches = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*port)
    assert ssd_scan_bwd.launches == launches      # CPU: plain version only
    for name, gt, w, src in zip(NAMES, got, want, port[:5]):
        assert gt.shape == src.shape, name
        assert gt.dtype == (torch.float32 if name in ("ddt", "da")
                            else src.dtype), name
        assert _rel_err(gt, w) <= 2e-5, (name, _rel_err(gt, w))


@pytest.mark.parametrize("L", [1, 64, 65, 189])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_matches_autograd_of_plain_forward(L, g):
    _, port = _inputs(1, L, 4, g, 16, 8, seed=L)
    leaves = [t.clone().requires_grad_(True) for t in port[:5]]
    y, _ = ssd_scan_plain(*leaves)
    want = torch.autograd.grad(y, leaves, port[5])
    got = ssd_scan_bwd_plain(*port)
    for name, gt, w in zip(NAMES, got, want):
        assert _rel_err(gt, w.numpy()) <= 4e-5, (name, _rel_err(gt, w))


# The bf16 route of the kernel runs every product on the tensor cores:
# bf16 x bf16 products exact in fp32, and each fp32 operand split into
# bf16 parts before its product.  Its parts per operand:
SPLIT = {"bw": 2,      # B * w of S_own (bwd_chunk)
         "cw": 2,      # C * exp(a_cs) of D_own (bwd_chunk)
         "s_in": 2,    # S_in's planes (bwd_carry), in dY.S_in^T
         "g_out": 2,   # G_out's planes, in X.G_out^T and B.G_out
         "m1dt": 2,    # M1 * dt_j, times B: dC's intra term
         "m1t": 2,     # M1^T, times C: u's backward term
         "m3t": 2}     # M3^T, times dY: dx's backward term


def _parts(v, k):
    """``v`` as ``k`` bf16 parts that add up to it to ~8k significant
    bits, the smallest first."""
    out = []
    for _ in range(k):
        hi = v.bfloat16().float()
        out.append(hi)
        v = v - hi
    return out[::-1]


def _mm(eq, parts, b):
    """``einsum(eq, part, b)`` of each part of an fp32 operand with the
    bf16-valued ``b``, added small first."""
    out = torch.einsum(eq, parts[0], b)
    for part in parts[1:]:
        out = out + torch.einsum(eq, part, b)
    return out


def _carry(own, own_adj, last, zero):
    """bwd_carry: each chunk's entry state S_in, carried forward from zero,
    and G_out, the adjoint carried back from zero after the last chunk; the
    last chunk's own state and the first chunk's own adjoint are not read."""
    s_in = [zero]
    for s_own, a_last in zip(own[:-1], last):
        s_in.append(torch.exp(a_last)[..., None, None] * s_in[-1] + s_own)
    g_out = [zero]
    for adj, a_last in zip(own_adj[:0:-1], last[:0:-1]):
        g_out.append(torch.exp(a_last)[..., None, None] * g_out[-1] + adj)
    return s_in, g_out[::-1]


def _dlog(v, k, w, wm):
    """dlog_t from its four sums of products: v's suffix sums, k, w's
    exclusive prefix sums and the rectangle sum_{tau >= t > j} W[tau][j]."""
    t = v.shape[-1]
    rect = torch.stack([wm[..., s:, :s].sum((-1, -2)) for s in range(t)], -1)
    return (torch.flip(torch.cumsum(torch.flip(v, [-1]), -1), [-1])
            + k[..., None] + torch.cumsum(w, -1) - w + rect)


def _bwd_passes(x, dt, a, bm, cm, dy, q=_KERNEL_CK, parts=None):
    """The backward kernel's passes (``csrc/ssd_scan_bwd.cu``) in torch on
    unpadded inputs: (dx in x's dtype, ddt, da, db, dc in their dtypes).
    ``parts`` None: the fp32 route, fp32 throughout.  ``parts`` a dict as
    SPLIT: the bf16 route's products, each fp32 operand split into its
    ``parts[name]`` bf16 parts, and the dead S_own of the last chunk and
    D_own of the first skipped."""
    bsz, L, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    bf = bm.float().repeat_interleave(rep, 2)           # [B, L, H, N]
    cf = cm.float().repeat_interleave(rep, 2)
    spans = [slice(c0, min(L, c0 + q)) for c0 in range(0, L, q)]
    own, own_adj, last, cums = [], [], [], []
    for i, sl in enumerate(spans):                      # bwd_chunk
        acs = a * torch.cumsum(dtf[:, sl], 1)           # [B, T, H]
        w = torch.exp(acs[:, -1:] - acs) * dtf[:, sl]
        if parts is None:
            own.append(torch.einsum("bth,bthn,bthp->bhnp", w, bf[:, sl],
                                    xf[:, sl]))
            own_adj.append(torch.einsum("bth,bthn,bthp->bhnp",
                                        torch.exp(acs), cf[:, sl],
                                        dyf[:, sl]))
        else:
            own.append(None if i + 1 == len(spans) else _mm(
                "bthn,bthp->bhnp", _parts(bf[:, sl] * w[..., None],
                                          parts["bw"]), xf[:, sl]))
            own_adj.append(None if i == 0 else _mm(
                "bthn,bthp->bhnp", _parts(cf[:, sl] * torch.exp(acs)[
                    ..., None], parts["cw"]), dyf[:, sl]))
        last.append(acs[:, -1])
        cums.append(acs)
    s_in, g_out = _carry(own, own_adj, last, torch.zeros(bsz, h, n, p))
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dbh, dch = torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros(bsz, h)
    for i, (sl, acs) in enumerate(zip(spans, cums)):   # bwd_out
        at = acs.transpose(1, 2)                        # [B, H, T]
        t = at.shape[-1]
        tril = torch.ones(t, t, dtype=torch.bool).tril()
        decay = torch.exp(torch.where(
            tril, at[..., :, None] - at[..., None, :], float("-inf")))
        xc, dyc, bc, cc = xf[:, sl], dyf[:, sl], bf[:, sl], cf[:, sl]
        dtc = dtf[:, sl].transpose(1, 2)                # [B, H, T]
        m1 = torch.einsum("bthp,bjhp->bhtj", dyc, xc) * decay
        m3 = torch.einsum("bthn,bjhn->bhtj", cc, bc) * decay
        out_w = torch.exp(at[..., -1:] - at)            # exp(a_last - a_cs_t)
        if parts is None:
            d_c = (torch.exp(at)[..., None]
                   * torch.einsum("bthp,bhnp->bhtn", dyc, s_in[i])
                   + torch.einsum("bhtj,bhj,bjhn->bhtn", m1, dtc, bc))
            u = (torch.einsum("bhjt,bjhn->bhtn", m1, cc)
                 + out_w[..., None] * torch.einsum("bhnp,bthp->bhtn",
                                                   g_out[i], xc))
            d_x = (torch.einsum("bhjt,bjhp->bhtp", m3, dyc)
                   + out_w[..., None] * torch.einsum("bthn,bhnp->bhtp", bc,
                                                     g_out[i]))
            # dlog_t = lam_t <G_t, s_{t-1}> in four sums of products
            v = torch.exp(at) * torch.einsum(
                "bthn,bhnp,bthp->bht", cc, s_in[i], dyc)
            k = torch.exp(at[..., -1]) * (g_out[i] * s_in[i]).sum((-1, -2))
            w = out_w * dtc * torch.einsum("bthn,bhnp,bthp->bht", bc,
                                           g_out[i], xc)
        else:
            s_p = _parts(s_in[i], parts["s_in"])        # the planes
            g_p = _parts(g_out[i], parts["g_out"])
            sdy = _mm("bhnp,bthp->bhtn", s_p, dyc)      # S_in dy_t
            gx = _mm("bhnp,bthp->bhtn", g_p, xc)        # G_out x_t
            d_c = (torch.exp(at)[..., None] * sdy + _mm(
                "bhtj,bjhn->bhtn", _parts(m1 * dtc[..., None, :],
                                          parts["m1dt"]), bc))
            u = (_mm("bhtj,bjhn->bhtn",
                     _parts(m1.transpose(-1, -2), parts["m1t"]), cc)
                 + out_w[..., None] * gx)
            d_x = (_mm("bhtj,bjhp->bhtp",
                       _parts(m3.transpose(-1, -2), parts["m3t"]), dyc)
                   + out_w[..., None] * _mm("bhnp,bthn->bhtp", g_p, bc))
            v = torch.exp(at) * (cc.transpose(1, 2) * sdy).sum(-1)
            k = torch.exp(at[..., -1]) * (sum(g_p) * sum(s_p)).sum((-1, -2))
            w = out_w * dtc * (bc.transpose(1, 2) * gx).sum(-1)
        dx[:, sl] = (dtc[..., None] * d_x).transpose(1, 2)
        dch[:, sl] = d_c.transpose(1, 2)
        dbh[:, sl] = (dtc[..., None] * u).transpose(1, 2)
        qv = (bc.transpose(1, 2) * u).sum(-1)           # B_t . u_t
        wm = m1 * torch.einsum("bthn,bjhn->bhtj", cc, bc) * dtc[..., None, :]
        dlog = _dlog(v, k, w, wm)
        ddt[:, sl] = (a[:, None] * dlog + qv).transpose(1, 2)
        da = da + (dtc * dlog).sum(-1)
    db = dbh.reshape(bsz, L, g, rep, -1).sum(3)
    dc = dch.reshape(bsz, L, g, rep, -1).sum(3)
    return (dx.to(x.dtype), ddt, da.sum(0), db.to(bm.dtype),
            dc.to(cm.dtype))


def _within_tol(name, got, want, dtype) -> None:
    atol, rtol = TOL_BWD[dtype]
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert bool(g.isfinite().all()), name
    assert bool(((g - w).abs() <= atol * scale + rtol * w.abs()).all()), \
        (name, float((g - w).abs().max()), scale)


@pytest.mark.parametrize("L", [1, 63, 64, 65, 189, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_mirror(L, dtype):
    """The kernel's passes on strided views (H 4 over G 2) against the plain
    version at the kernel's tolerance (bfloat16: the tensor-core route's
    products, SPLIT) and, in float32, against jax.grad of the reference at
    the plain version's."""
    ref, port = _inputs(2, L, 4, 2, 32, 16, seed=L, dtype=dtype,
                        strided=True)
    assert not port[0].is_contiguous() and not port[3].is_contiguous()
    got = _bwd_passes(*port, parts=SPLIT if dtype == "bfloat16" else None)
    want = ssd_scan_bwd_plain(*port)
    for name, gt, w in zip(NAMES, got, want):
        _within_tol(name, gt, w, dtype)
    if dtype == "float32":
        for name, gt, w in zip(NAMES, got, _ref_grads(*ref)):
            assert _rel_err(gt, w) <= 2e-5, (name, _rel_err(gt, w))


def test_kernel_mirror_long_and_shared():
    """4,096 steps (64 chunks) with all 8 heads on one B/C group, N 64."""
    _, port = _inputs(1, 4096, 8, 1, 16, 64, seed=1, strided=True)
    got = _bwd_passes(*port)
    want = ssd_scan_bwd_plain(*port)
    for name, gt, w in zip(NAMES, got, want):
        _within_tol(name, gt, w, "float32")


def test_kernel_mirror_bf16_long():
    """The bf16 route's products over 4,096 steps (64 chunks, every S_in and
    G_out carried), all 8 heads on one B/C group, N 64."""
    _, port = _inputs(1, 4096, 8, 1, 16, 64, seed=1, dtype="bfloat16",
                      strided=True)
    got = _bwd_passes(*port, parts=SPLIT)
    want = ssd_scan_bwd_plain(*port)
    for name, gt, w in zip(NAMES, got, want):
        _within_tol(name, gt, w, "bfloat16")


def _outside_tol(got, want, dtype="bfloat16") -> int:
    """Elements of ``got`` outside TOL_BWD around ``want``."""
    atol, rtol = TOL_BWD[dtype]
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    return int(((g - w).abs() > atol * scale + rtol * w.abs()).sum())


# per operand the bf16 route splits: (B, L, H, G, P, N, seed, a's scale), a
# draw where rounding that operand once to bf16 shows; a scaled by 0.01
# decays slowly, so the states carry over several chunks
ROUNDED_ONCE = {"bw": (2, 300, 4, 1, 64, 64, 6, 0.01),
                "cw": (2, 300, 4, 1, 64, 64, 6, 0.01),
                "s_in": (2, 300, 4, 1, 64, 64, 2, 0.01),
                "g_out": (2, 300, 4, 1, 64, 64, 4, 0.01),
                "m1dt": (2, 300, 4, 1, 64, 64, 5, 0.01),
                "m1t": (2, 300, 4, 1, 64, 64, 2, 1.0),
                "m3t": (2, 189, 4, 2, 32, 16, 6, 1.0)}


@pytest.mark.parametrize("name", sorted(ROUNDED_ONCE))
def test_one_bf16_rounding_misses_the_tol(name):
    """Why the bf16 route splits each of its fp32 operands: on the same
    inputs the split products stay within TOL_BWD, and rounding that one
    operand once to bf16 instead leaves elements of a gradient outside."""
    b, L, h, g, p, n, seed, scale = ROUNDED_ONCE[name]
    _, port = _inputs(b, L, h, g, p, n, seed=seed, dtype="bfloat16",
                      strided=True)
    port = (*port[:2], port[2] * scale, *port[3:])
    want = ssd_scan_bwd_plain(*port)
    split = _bwd_passes(*port, parts=SPLIT)
    once = _bwd_passes(*port, parts={**SPLIT, name: 1})
    assert sum(_outside_tol(gt, w) for gt, w in zip(split, want)) == 0
    assert sum(_outside_tol(gt, w) for gt, w in zip(once, want)) > 0, name


def _model_like(dtype, seed=3, L=70):
    """An xbc buffer that requires grad and the scan's inputs cut from it
    as ``models/ssd.py`` cuts them, with dt and a from leaves too."""
    b, h, g, p, n = 2, 4, 1, 16, 16
    _, port = _inputs(b, L, h, g, p, n, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, L, h * p + 2 * g * n)).astype(np.float32)).to(
            getattr(torch, dtype)).requires_grad_(True)
    dt_raw = torch.from_numpy(rng.standard_normal(
        (b, L, h)).astype(np.float32)).requires_grad_(True)
    a_log = torch.zeros(h, requires_grad=True)
    return xbc, dt_raw, a_log, port[5]


def _scan_of(xbc, dt_raw, a_log, h=4, p=16, n=16):
    b, L, _ = xbc.shape
    x = xbc[..., :h * p].reshape(b, L, h, p)
    bm = xbc[..., h * p:h * p + n].reshape(b, L, 1, n)
    cm = xbc[..., h * p + n:].reshape(b, L, 1, n)
    dt = torch.nn.functional.softplus(dt_raw)
    return ssd_scan(x, dt, -torch.exp(a_log), bm, cm)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_under_checkpoint(dtype):
    """Gradients through ``SsdScanFn`` reach the xbc buffer the views are cut
    from, dt's and a's leaves, and equal ``ssd_scan_bwd`` on the same
    views; under ``torch.utils.checkpoint`` they are bitwise those without
    it.  The final state takes no gradient."""
    xbc, dt_raw, a_log, dy = _model_like(dtype)
    grads = []
    for remat in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xbc, dt_raw, a_log)]
        y = (checkpoint(_scan_of, *leaves, use_reentrant=False) if remat
             else _scan_of(*leaves))
        grads.append(torch.autograd.grad(y, leaves, dy))
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)
    x = xbc.detach()
    h, p, n = 4, 16, 16
    b, L, _ = x.shape
    views = (x[..., :h * p].reshape(b, L, h, p),
             torch.nn.functional.softplus(dt_raw.detach()),
             -torch.exp(a_log.detach()),
             x[..., h * p:h * p + n].reshape(b, L, 1, n),
             x[..., h * p + n:].reshape(b, L, 1, n))
    dx, ddt, da, db, dc = ssd_scan_bwd(*views, dy)
    want = torch.cat([dx.reshape(b, L, -1), db.reshape(b, L, -1),
                      dc.reshape(b, L, -1)], -1)
    assert torch.equal(grads[0][0], want)
    sig = torch.sigmoid(dt_raw.detach())
    assert torch.allclose(grads[0][1], ddt * sig, rtol=1e-6, atol=0)
    state = ssd_scan(*(t.requires_grad_(True) if i == 0 else t
                       for i, t in enumerate(views)))[1]
    assert not state.requires_grad


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_function_takes_expanded_dy(reduce):
    """``y.sum()`` and ``y.mean()`` hand the backward a dy expanded from
    one element (every stride 0): the gradients equal ``ssd_scan_bwd`` of
    that dy made contiguous, and of the expanded dy with x as a view whose
    innermost stride is not 1 (the kernel's wrapper copies both on the
    card: ``chip_smoke.py``'s ``edge_ssd_bwd``)."""
    _, port = _inputs(2, 70, 4, 2, 8, 16, 5)
    x, dt, a, bm, cm, _ = port
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    y = ssd_scan(*leaves)[0]
    grads = torch.autograd.grad(getattr(y, reduce)(), leaves)
    dy = torch.full_like(x, 1.0 if reduce == "sum" else 1.0 / x.numel())
    want = ssd_scan_bwd(x, dt, a, bm, cm, dy)
    xt = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert xt.stride(-1) != 1
    again = ssd_scan_bwd(xt, dt, a, bm, cm, dy[:1, :1, :1, :1].expand_as(x))
    for g, w, w2 in zip(grads, want, again):
        assert torch.equal(g, w)
        assert torch.equal(w2, w)


BAD = [  # x dtype, b dtype, dy dtype, dt dtype, n, p, error
    ("float16", "float16", "float16", "float32", 16, 16, TypeError),
    ("bfloat16", "bfloat16", "float32", "float32", 16, 16, TypeError),
    ("float32", "bfloat16", "float32", "float32", 16, 16, TypeError),
    ("bfloat16", "bfloat16", "bfloat16", "float32", 8, 16, ValueError),
    ("float32", "float32", "float32", "float32", 6, 4, ValueError),
    ("float32", "float32", "float32", "float32", 16, 6, ValueError),
    ("bfloat16", "bfloat16", "bfloat16", "float32", 128, 40, ValueError),
]


@pytest.mark.parametrize("xd,bd,dyd,dtd,n,p,err", BAD)
def test_kernel_check_rejects(xd, bd, dyd, dtd, n, p, err):
    """What the kernel does not take raises before a launch (the wrapper's
    check on CUDA tensors; it never falls back to the plain version):
    dtypes other than all-fp32 or all-bf16, and N or P off its multiples.
    A shape past a block's shared memory is refused by the kernel's own
    entry, which the wrapper turns into a ValueError (N 144 with P 64, on
    the card: ``chip_smoke.py``'s ``edge_ssd_bwd``)."""
    x = torch.zeros(1, 4, 2, p, dtype=getattr(torch, xd))
    b = torch.zeros(1, 4, 1, n, dtype=getattr(torch, bd))
    dy = torch.zeros(1, 4, 2, p, dtype=getattr(torch, dyd))
    dt = torch.zeros(1, 4, 2, dtype=getattr(torch, dtd))
    with pytest.raises(err):
        _bwd_kernel_check(x, dt, b, b, dy)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 8, 4, 4)
    args = (x, torch.zeros(1, 8, 4), torch.zeros(4), torch.zeros(1, 8, 2, 4),
            torch.zeros(1, 8, 2, 4))
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(*args, torch.zeros(1, 8, 4, 5))
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_bwd(x, torch.zeros(1, 8, 4), torch.zeros(4),
                     torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4), x)
