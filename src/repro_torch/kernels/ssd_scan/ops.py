"""Mamba2 SSD chunked scan — the port of the ssd_scan TPU kernel
(``repro/kernels/ssd_scan/kernel.py``: ``_ssd_kernel`` / ``ssd_scan_call``,
wrapper ``ops.py``).

Per head, ``s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T`` and
``y_t = C_t s_t``, computed chunk by chunk: the intra-chunk term as
``[CK, CK]`` products, the inter-chunk term from the carried ``[N, P]``
state.  Both versions return y and the final state ``s_L`` (fp32): the
reference's wrapper returns y only and its model recomputes the state
with a second, sequential fp32 scan whose dt is fp32 (``ssd_final_state``).
``dt`` may be float32 with bf16 x, B and C, as the reference's default
route (``ssd_scan_ref``) feeds y the fp32 softplus output.  Given an fp32
``state_dt``, both versions compute the final state from it in fp32 (the
kernel as a second chain through its first two passes, from the tiles
they already hold, with ~24 significant bits of each chunk's products)
and y from ``dt`` as before; without it the state comes from y's own scan
(~16 bits of those products in bf16).
:func:`ssd_scan` takes the reference wrapper's model-layout API.  On a
CPU tensor it runs :func:`ssd_scan_plain`, which pads L exactly as the
reference's ``ops.py`` does (``ckk = min(ck, L) if L % ck else ck``,
zeros, so dt = 0 on padded steps).  On a CUDA tensor it launches the
three passes of ``csrc/ssd_scan.cu`` over 64-step chunks (each chunk's own
end state, the states carried across chunks, then y), which read x, dt, B
and C through their strides, B and C per group, and write y in place: no
padding, transposing or repeating copy.  Both evaluate
``exp(a_cs_t - a_cs_j)`` only for ``j <= t``.

Gradients: when grad is on and x, dt, a, b or c requires it, the call goes
through :class:`SsdScanFn`, whose backward is :func:`ssd_scan_bwd`: on
CUDA tensors the passes of ``csrc/ssd_scan_bwd.cu`` (its own launch
counter; the forward's chunked form run backwards, bf16 on the tensor
cores with the forward's hi/lo split, fp32 on the CUDA cores,
deterministic; three kernels for a sequence of one chunk, five for
more), on CPU tensors :func:`ssd_scan_bwd_plain`, the adjoint recurrence
written out.  The reference has no backward kernel: it takes
``jax.grad`` of ``ssd_scan_ref``.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from .. import _build

DEFAULT_CK = 128
_KERNEL_CK = 64      # the kernel's chunk (csrc/ssd_scan.cu, kQ)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# sizes and (batch, step, head) strides of x, dt, b, c, y, state_dt, as
# int64
_DIMS = struct.Struct("<24q")
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_void_p]
# the backward's sizes and (batch, step, head) strides of x, dt, b, c, dy
_BWD_DIMS = struct.Struct("<21q")
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_void_p]
_INVALID_VALUE = 1   # cudaErrorInvalidValue: a C entry's refusal of a shape
_launch = None       # the C entries, resolved at the first CUDA call
_launch_bwd = None
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


def _check(x, dt, a, b, c, state_dt=None) -> None:
    bsz, L, h, p = x.shape
    g = b.shape[2]
    if (dt.shape != (bsz, L, h) or a.shape != (h,) or b.ndim != 4
            or b.shape[:2] != (bsz, L) or c.shape != b.shape or h % g):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    extra = ()
    if state_dt is not None:
        if state_dt.shape != dt.shape or state_dt.dtype is not torch.float32:
            raise ValueError(f"state_dt must be float32 of dt's shape "
                             f"{tuple(dt.shape)}, not {state_dt.dtype} "
                             f"{tuple(state_dt.shape)}")
        extra = (state_dt,)
    if len({t.get_device() for t in (x, dt, a, b, c, *extra)}) != 1:
        raise ValueError("ssd_scan inputs must be on one device")


def _padded_heads(t: torch.Tensor, pad: int) -> torch.Tensor:
    """[B, L, H, ...] -> [B*H, L + pad, ...], zero-padded along L."""
    t = torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) \
        if pad else t
    t = t.movedim(2, 1)
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def _chunk(L: int, ck: int) -> tuple[int, int]:
    """The reference wrapper's chunk and padding (``ops.py:24-25``)."""
    ckk = min(ck, L) if L % ck else ck
    return ckk, (-L) % ckk


def _chunk_state(state, xc, dtc, bc, ah):
    """The state carried over one chunk: decayed by the chunk's total
    ``exp(a * sum dt)``, plus ``sum_j B_j w_j x_j^T``."""
    a_cs = ah[:, None] * torch.cumsum(dtc, dim=1)            # [BH, CK]
    wj = torch.exp(a_cs[:, -1:] - a_cs) * dtc
    return (torch.exp(a_cs[:, -1])[:, None, None] * state
            + (bc * wj[..., None]).transpose(1, 2) @ xc)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   ck: int = DEFAULT_CK,
                   state_dt: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, fp32 throughout, in the TPU
    kernel's chunks of ``ckk`` steps, batched over every head; the final
    state from ``state_dt`` when it is given."""
    _check(x, dt, a, b, c, state_dt)
    bsz, L, h, p = x.shape
    rep = h // b.shape[2]
    ckk, pad = _chunk(L, ck)
    xh = _padded_heads(x, pad).float()                       # [BH, Lp, P]
    dth = _padded_heads(dt[..., None], pad)[..., 0].float()  # [BH, Lp]
    bh_ = _padded_heads(b.repeat_interleave(rep, dim=2), pad).float()
    ch_ = _padded_heads(c.repeat_interleave(rep, dim=2), pad).float()
    ah = a.float().repeat(bsz)                               # [BH]
    n_heads, lp, n = bh_.shape
    state = torch.zeros(n_heads, n, p, dtype=torch.float32, device=x.device)
    tril = torch.ones(ckk, ckk, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(xh)
    for c0 in range(0, lp, ckk):
        xc, dtc = xh[:, c0:c0 + ckk], dth[:, c0:c0 + ckk]
        bc, cc = bh_[:, c0:c0 + ckk], ch_[:, c0:c0 + ckk]
        a_cs = ah[:, None] * torch.cumsum(dtc, dim=1)        # [BH, CK]
        yc = torch.exp(a_cs)[..., None] * (cc @ state)
        diff = torch.where(tril, a_cs[:, :, None] - a_cs[:, None, :],
                           float("-inf"))
        w = (cc @ bc.transpose(1, 2)) * torch.exp(diff) * dtc[:, None, :]
        y[:, c0:c0 + ckk] = yc + w @ xc
        state = _chunk_state(state, xc, dtc, bc, ah)
    if state_dt is not None and state_dt is not dt:
        dth = _padded_heads(state_dt[..., None], pad)[..., 0].float()
        state = torch.zeros_like(state)
        for c0 in range(0, lp, ckk):
            state = _chunk_state(state, xh[:, c0:c0 + ckk],
                                 dth[:, c0:c0 + ckk], bh_[:, c0:c0 + ckk], ah)
    y = y.reshape(bsz, h, lp, p).movedim(1, 2)[:, :L]
    return y.to(x.dtype), state.reshape(bsz, h, n, p)


def _check_dy(x, dy) -> None:
    if dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}, not "
                         f"{tuple(dy.shape)}")
    if dy.get_device() != x.get_device():
        raise ValueError("ssd_scan_bwd inputs must be on one device")


def _group_sum(t: torch.Tensor, bsz: int, h: int, g: int,
               L: int) -> torch.Tensor:
    """[B*H, Lp, N] per-head gradients -> [B, L, G, N], each group's heads
    added in head order."""
    t = t.reshape(bsz, g, h // g, t.shape[1], t.shape[2])[:, :, :, :L]
    out = t[:, :, 0]
    for r in range(1, h // g):
        out = out + t[:, :, r]
    return out.movedim(1, 2)


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                       *, ck: int = DEFAULT_CK):
    """(dx, ddt, da, db, dc): the gradient of y = ``ssd_scan(x, dt, a, b,
    c)[0]`` against ``dy``, written out as the adjoint recurrence in plain
    torch, fp32 throughout, in the forward's chunks (no autograd).  Per
    head, with lam_t = exp(dt_t a), states s_t and the adjoint of the state
    G_t = C_t dy_t^T + lam_{t+1} G_{t+1} ([N, P], scanned in reverse):

        dC_t = s_t dy_t            dx_t = dt_t G_t^T B_t
        dB_t = dt_t G_t x_t        da = sum_t dt_t lam_t <G_t, s_{t-1}>
        ddt_t = a lam_t <G_t, s_{t-1}> + <G_t, B_t x_t^T>

    The chunks' entry states come from a forward pass over the chunks;
    then, chunk by chunk in reverse, every step's s_t and G_t from the
    chunk's entry state and the adjoint carried in from the chunks after
    it.  dB and dC are summed over each group's heads in head order, da
    over the batch in order.  dx, db and dc come back in their inputs'
    dtypes, ddt and da in float32."""
    _check(x, dt, a, b, c)
    _check_dy(x, dy)
    bsz, L, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    ckk, pad = _chunk(L, ck)
    xh = _padded_heads(x, pad).float()                       # [BH, Lp, P]
    dyh = _padded_heads(dy, pad).float()
    dth = _padded_heads(dt[..., None], pad)[..., 0].float()  # [BH, Lp]
    bh_ = _padded_heads(b.repeat_interleave(rep, dim=2), pad).float()
    ch_ = _padded_heads(c.repeat_interleave(rep, dim=2), pad).float()
    ah = a.float().repeat(bsz)                               # [BH]
    n_heads, lp = xh.shape[0], xh.shape[1]
    dev = x.device
    starts = list(range(0, lp, ckk))
    s_in = [torch.zeros(n_heads, n, p, dtype=torch.float32, device=dev)]
    for c0 in starts[:-1]:
        s_in.append(_chunk_state(s_in[-1], xh[:, c0:c0 + ckk],
                                 dth[:, c0:c0 + ckk], bh_[:, c0:c0 + ckk],
                                 ah))
    dx, dbh, dch = (torch.zeros_like(t) for t in (xh, bh_, ch_))
    ddt = torch.zeros_like(dth)
    da = torch.zeros(n_heads, dtype=torch.float32, device=dev)
    g_out = torch.zeros(n_heads, n, p, dtype=torch.float32, device=dev)
    tril = torch.ones(ckk, ckk, dtype=torch.bool, device=dev).tril()
    for c0, s0 in zip(reversed(starts), reversed(s_in)):
        sl = slice(c0, c0 + ckk)
        xc, dtc, bc, cc, dyc = xh[:, sl], dth[:, sl], bh_[:, sl], ch_[:, sl], \
            dyh[:, sl]
        a_cs = ah[:, None] * torch.cumsum(dtc, dim=1)        # [BH, CK]
        diff = torch.where(tril, a_cs[:, :, None] - a_cs[:, None, :],
                           float("-inf"))
        decay = torch.exp(diff)                              # [t, j], j <= t
        s = (torch.exp(a_cs)[..., None, None] * s0[:, None]
             + torch.einsum("btj,bjn,bjp->btnp", decay * dtc[:, None, :],
                            bc, xc))
        adj = (torch.einsum("btj,btn,btp->bjnp", decay, cc, dyc)
               + torch.exp(a_cs[:, -1:] - a_cs)[..., None, None]
               * g_out[:, None])
        s_prev = torch.cat([s0[:, None], s[:, :-1]], dim=1)
        lam = torch.exp(ah[:, None] * dtc)
        dch[:, sl] = torch.einsum("btnp,btp->btn", s, dyc)
        dx[:, sl] = dtc[..., None] * torch.einsum("btnp,btn->btp", adj, bc)
        u = torch.einsum("btnp,btp->btn", adj, xc)
        dbh[:, sl] = dtc[..., None] * u
        dlog = lam * (adj * s_prev).sum(dim=(2, 3))          # d/d(dt_t a)
        ddt[:, sl] = ah[:, None] * dlog + (bc * u).sum(dim=2)
        da = da + (dtc * dlog).sum(dim=1)
        g_out = lam[:, 0, None, None] * adj[:, 0]
    dx = dx.reshape(bsz, h, lp, p).movedim(1, 2)[:, :L]
    ddt = ddt.reshape(bsz, h, lp).movedim(1, 2)[:, :L]
    da = da.reshape(bsz, h)
    da_sum = torch.zeros(h, dtype=torch.float32, device=dev)
    for i in range(bsz):
        da_sum = da_sum + da[i]
    return (dx.to(x.dtype), ddt.contiguous(), da_sum,
            _group_sum(dbh, bsz, h, g, L).to(b.dtype),
            _group_sum(dch, bsz, h, g, L).to(c.dtype))


def _rows_aligned(t: torch.Tensor, elems: int) -> torch.Tensor:
    """``t`` itself when its innermost dimension is contiguous and its base
    pointer and other strides are whole 16-byte chunks, as the kernel's
    cp.async tile loads need (true of the model's views of ``xbc``); a
    contiguous copy otherwise."""
    st = t.stride()
    if st[-1] == 1 and t.data_ptr() % 16 == 0 \
            and not (st[0] % elems or st[1] % elems or st[2] % elems):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _resolve() -> None:
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("ssd_scan", "ssd_scan_launch", _ARGTYPES)


def _forward(x, dt, a, b, c, ck, state_dt):
    """(y, final state): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    _check(x, dt, a, b, c, state_dt)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return ssd_scan_plain(x, dt, a, b, c, ck=ck, state_dt=state_dt)
    code = _DTYPES.get(x.dtype)
    if code is None or not (x.dtype == b.dtype == c.dtype) \
            or dt.dtype not in (x.dtype, torch.float32):
        raise TypeError("ssd_scan kernel takes x, b and c all float32 or "
                        "all bfloat16, and dt in their dtype or float32")
    bsz, L, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (n % 16 or p % 16) if code else (n % 4 or p % 4):
        raise ValueError(
            "ssd_scan kernel takes state and head sizes that are multiples "
            f"of 16 (bfloat16) or of 4 (float32), not N={n}, P={p}")
    y = torch.empty((bsz, L, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    elems = 16 // x.element_size()
    x, b, c = (_rows_aligned(t, elems) for t in (x, b, c))
    if a.dtype is not torch.float32 or not a.is_contiguous():
        a = a.float().contiguous()
    if state_dt is dt and code == 0:
        state_dt = None     # fp32 inputs: y's own scan gives the same state
    dt = dt.float()         # the kernel reads fp32 dt; bf16 converts exactly
    sd_strides = (0, 0, 0) if state_dt is None else state_dt.stride()
    chunks = -(-L // _KERNEL_CK)
    # per chunk and head: its own end state (fp32), the carried state as
    # bf16 hi and lo planes (bf16 inputs), its decay; and the final state
    # run's own end state and decay (state_dt)
    runs = 1 if state_dt is None else 2
    scratch = torch.empty(bsz * h * chunks * (n * p * (code + runs) + runs),
                          dtype=torch.float32, device=x.device)
    dims = _DIMS.pack(bsz, L, h, g, n, p, *x.stride()[:3], *dt.stride(),
                      *b.stride()[:3], *c.stride()[:3], *y.stride()[:3],
                      *sd_strides)
    if _launch is None:
        _resolve()
    err = _launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(),
                  None if state_dt is None else state_dt.data_ptr(),
                  y.data_ptr(), state.data_ptr(),
                  scratch.data_ptr(), dims, code,
                  _raw_stream(x.get_device()))
    if err:
        _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


def _bwd_kernel_check(x, dt, b, c, dy) -> None:
    """Raises on what the backward kernel does not take."""
    if x.dtype not in _DTYPES or not (x.dtype == b.dtype == c.dtype
                                      == dy.dtype) \
            or dt.dtype not in (x.dtype, torch.float32):
        raise TypeError("ssd_scan_bwd kernel takes x, b, c and dy all "
                        "float32 or all bfloat16, and dt in their dtype or "
                        "float32")
    bsz, L, h, p = x.shape
    n = b.shape[3]
    if (n % 16 or p % 16) if x.dtype is torch.bfloat16 else (n % 4 or p % 4):
        raise ValueError(
            "ssd_scan_bwd kernel takes state and head sizes that are "
            f"multiples of 16 (bfloat16) or of 4 (float32), not N={n}, P={p}")


def _resolve_bwd() -> None:
    global _launch_bwd, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch_bwd = _build.load("ssd_scan_bwd", "ssd_scan_bwd_launch",
                              _BWD_ARGTYPES)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                 ck: int = DEFAULT_CK):
    """(dx, ddt, da, db, dc) of y = ``ssd_scan(x, dt, a, b, c)[0]`` given
    y's gradient ``dy`` (x's dtype and shape): dx, db and dc in their
    inputs' dtypes, ddt [B, L, H] and da [H] in float32.  On CUDA tensors
    the passes of ``csrc/ssd_scan_bwd.cu`` (one launch counted), which read
    x, dt, B, C and dy through their strides (a row's elements at unit
    stride, 16-byte aligned: others are copied once); on CPU tensors
    :func:`ssd_scan_bwd_plain` (``ck``: its chunk, as the forward's).
    Raises ValueError on a shape the kernel does not
    take, and never falls back to the plain version on the card."""
    _check(x, dt, a, b, c)
    _check_dy(x, dy)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return ssd_scan_bwd_plain(x, dt, a, b, c, dy, ck=ck)
    _bwd_kernel_check(x, dt, b, c, dy)
    bsz, L, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    dx = torch.empty((bsz, L, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, L, h), dtype=torch.float32, device=dev)
    da = torch.empty((h,), dtype=torch.float32, device=dev)
    db = torch.empty((bsz, L, g, n), dtype=b.dtype, device=dev)
    dc = torch.empty((bsz, L, g, n), dtype=c.dtype, device=dev)
    if dx.numel() == 0:
        return dx, ddt.zero_(), da.zero_(), db.zero_(), dc.zero_()
    # the kernel reads a row's elements at unit stride, in bf16 by cp.async
    # from 16-byte aligned rows: a view whose innermost stride is not 1 (dy
    # expanded from y.sum()'s scalar, a transpose) or whose rows are not
    # aligned is copied
    elems = 16 // x.element_size()
    x, b, c, dy = (_rows_aligned(t, elems) for t in (x, b, c, dy))
    dt = dt.float()
    if a.dtype is not torch.float32 or not a.is_contiguous():
        a = a.float().contiguous()
    chunks = -(-L // _KERNEL_CK)
    bh = bsz * h
    code = _DTYPES[x.dtype]
    # per chunk and head: the own state and adjoint [N, P] (fp32), then
    # (bf16) the carried ones as hi and lo planes, the chunk's decay and its
    # da partial; per step and head: the dB and dC partials
    scratch = torch.empty((2 + 2 * code) * bh * chunks * n * p
                          + 2 * bh * chunks + 2 * bh * L * n,
                          dtype=torch.float32, device=dev)
    dims = _BWD_DIMS.pack(bsz, L, h, g, n, p, *x.stride()[:3], *dt.stride(),
                          *b.stride()[:3], *c.stride()[:3], *dy.stride()[:3])
    if _launch_bwd is None:
        _resolve_bwd()
    err = _launch_bwd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                      dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                      db.data_ptr(), dc.data_ptr(), scratch.data_ptr(), dims,
                      code, _raw_stream(x.get_device()))
    if err == _INVALID_VALUE:
        raise ValueError(
            f"ssd_scan_bwd kernel does not take B={bsz}, L={L}, H={h}, "
            f"G={g}, N={n}, P={p}: its entry refuses more than 65,535 "
            "(batch, head) rows, 2**30 steps or a block's shared memory "
            "(csrc/ssd_scan_bwd.cu, out_smem: at P 64, N up to 224 in "
            "bfloat16 and up to 140 in float32)")
    if err:
        _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc


class SsdScanFn(torch.autograd.Function):
    """ssd_scan with its gradient in x, dt, a, b and c: the forward saves
    the five inputs only (the backward recomputes the states, so remat
    keeps no [N, P] state a chunk); the backward is :func:`ssd_scan_bwd`
    (the kernel on the card, never the plain version there).  The final
    state is not differentiable."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, ck, state_dt):
        y, state = _forward(x, dt, a, b, c, ck, state_dt)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.ck = ck
        ctx.mark_non_differentiable(state)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        if dy is None:
            return (None,) * 7
        x, dt, a, b, c = ctx.saved_tensors
        dx, ddt, da, db, dc = ssd_scan_bwd(x, dt, a, b, c, dy, ck=ctx.ck)
        return dx, ddt.to(dt.dtype), da.to(a.dtype), db, dc, None, None


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, ck: int = DEFAULT_CK,
             state_dt: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, H, P]; dt: [B, L, H] in x's dtype or float32; a: [H];
    b, c: [B, L, G, N] with H % G == 0 -> (y [B, L, H, P] in x's dtype,
    final state [B, H, N, P] float32).  ``state_dt`` (float32, dt's
    shape; optional): the dt the final state is computed from, in fp32;
    y always uses ``dt``.  Inputs
    may be strided views (the model passes slices of one ``xbc`` buffer).
    On the CPU the plain version pads as the reference does (``ck``); the
    kernel takes no padding and ignores ``ck``: its 64-step chunks
    zero-fill the rows past L, with dt = 0.
    Differentiable in x, dt, a, b and c when grad is on and one of them
    requires it (:class:`SsdScanFn`, whose backward is
    :func:`ssd_scan_bwd`); the final state is not."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        return SsdScanFn.apply(x, dt, a, b, c, ck, state_dt)
    return _forward(x, dt, a, b, c, ck, state_dt)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
