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
_launch = None       # the C entry, resolved at the first CUDA call
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
    zero-fill the rows past L, with dt = 0."""
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


ssd_scan.launches = 0
