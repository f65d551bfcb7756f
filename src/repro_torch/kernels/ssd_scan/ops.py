"""Mamba2 SSD chunked scan — the port of the ssd_scan TPU kernel
(``repro/kernels/ssd_scan/kernel.py``: ``_ssd_kernel`` / ``ssd_scan_call``,
wrapper ``ops.py``).

Per head, ``s_t = exp(dt_t a) s_{t-1} + dt_t B_t x_t^T`` and
``y_t = C_t s_t``, computed chunk by chunk: the intra-chunk term as
``[CK, CK]`` products, the inter-chunk term from the carried ``[N, P]``
state.  Both versions return y and the final state ``s_L`` (fp32): the
reference's wrapper returns y only and its model recomputes the state with
a second, sequential scan; here a prefill takes it from the one scan.
:func:`ssd_scan` takes the reference wrapper's model-layout API and
pads L exactly as its ``ops.py`` does (``ckk = min(ck, L) if L % ck else
ck``, zeros, so dt = 0 on padded steps).  On a CUDA tensor it launches the
kernel in ``csrc/ssd_scan.cu`` (one block per head and group of up to 32
state columns, B and C read per group); on a CPU tensor it runs
:func:`ssd_scan_plain`.  Both evaluate ``exp(a_cs_t - a_cs_j)`` only for
``j <= t``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

DEFAULT_CK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, a, b, c) -> None:
    bsz, L, h, p = x.shape
    g = b.shape[2]
    if (dt.shape != (bsz, L, h) or a.shape != (h,) or b.ndim != 4
            or b.shape[:2] != (bsz, L) or c.shape != b.shape or h % g):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
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


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   ck: int = DEFAULT_CK) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, fp32 throughout, in the TPU
    kernel's chunks of ``ckk`` steps, batched over every head."""
    _check(x, dt, a, b, c)
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
        wj = torch.exp(a_cs[:, -1:] - a_cs) * dtc
        state = (torch.exp(a_cs[:, -1])[:, None, None] * state
                 + (bc * wj[..., None]).transpose(1, 2) @ xc)
    y = y.reshape(bsz, h, lp, p).movedim(1, 2)[:, :L]
    return y.to(x.dtype), state.reshape(bsz, h, n, p)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             ck: int = DEFAULT_CK) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, H, P]; dt: [B, L, H]; a: [H]; b, c: [B, L, G, N] with
    H % G == 0 -> (y [B, L, H, P] in x's dtype, final state [B, H, N, P]
    float32).  Padded steps have dt = 0, so they leave the state as it is."""
    _check(x, dt, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, ck=ck)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or not (x.dtype == dt.dtype == b.dtype
                                      == c.dtype):
        raise TypeError("ssd_scan kernel takes x, dt, b and c all float32 "
                        "or all bfloat16")
    bsz, L, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if p % 4 or n % 4:
        raise ValueError(f"ssd_scan kernel takes head and state sizes that "
                         f"are multiples of 4, not P={p}, N={n}")
    y = torch.empty_like(x)
    state = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state
    _, pad = _chunk(L, ck)
    xh = _padded_heads(x, pad)
    dth = _padded_heads(dt[..., None], pad)[..., 0].contiguous()
    bg, cg = _padded_heads(b, pad), _padded_heads(c, pad)
    ah = a.float().repeat(bsz).contiguous()
    yh = torch.empty_like(xh)
    fn = _build.load("ssd_scan", "ssd_scan_launch",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    err = fn(xh.data_ptr(), dth.data_ptr(), ah.data_ptr(), bg.data_ptr(),
             cg.data_ptr(), yh.data_ptr(), state.data_ptr(), bsz * h, h, g,
             L + pad, n, p, _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    y.copy_(yh.reshape(bsz, h, L + pad, p).movedim(1, 2)[:, :L])
    return y, state


ssd_scan.launches = 0
