"""Causal, sliding-window or non-causal attention with an online softmax,
and its gradient — the port of the flash_attention TPU kernel
(``repro/kernels/flash_attention/kernel.py``: ``_flash_kernel`` /
``flash_attention_call``, wrapper ``ops.py``).

:func:`flash_attention` takes the reference wrapper's ``[B, H, S, D]`` API.
On a CUDA tensor it launches the kernel in ``csrc/flash_attention.cu``; on
a CPU tensor it runs :func:`flash_attention_plain`.  bf16 inputs take the
kernel's tensor-core path, fp32 inputs its fp32 CUDA-core path.  The card
path is lean, as overlap_scan's is: the C entry is resolved once, the raw
current stream is read without building a ``torch.cuda.Stream``, and
inputs that are contiguous and 16-byte aligned are passed as they are.
Three things differ from the reference's wrapper and change no output:

* GQA: the kernel maps each query head to its kv head (``h // rep``)
  instead of materialising ``repeat``ed k and v;
* no padding of S to the block: the kernel masks keys past S itself, so
  non-causal calls of any length work too (the reference asserts there);
* a non-causal, unwindowed call may have Sk keys for Sq queries
  (whisper's cross attention); causal and windowed calls have Sk = Sq.

The semantics are the TPU kernel's: masked logits are ``-1e30`` (not -inf),
masked probabilities are zeroed, the denominator is clamped at 1e-30 (a
fully masked row gives 0), the scale is ``D ** -0.5`` unless given, and the
window keeps keys with ``qi - kj < window``.

Gradients: when q, k or v requires grad, the call goes through an
``autograd.Function`` whose forward also writes each row's fp32
log-sum-exp and whose backward is :func:`flash_attention_bwd`: on CUDA
tensors the hand-written kernels of ``csrc/flash_attention_bwd.cu`` (its
own launch counter; bf16 at every head_dim, 64, 128 and 256, on the
tensor cores with P and dS split into bf16 hi and lo halves, fp32 on the
CUDA cores), on CPU tensors :func:`flash_attention_bwd_plain`.
The reference has no backward kernel (it differentiates plain jnp
attention); the formulas are the standard ones, under the same mask.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _I, _P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 8 + [ctypes.c_float, _I, _P]
_launch = None       # the C entries, resolved at the first CUDA call
_launch_bwd = None
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


def _resolve() -> None:
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("flash_attention", "flash_attention_launch",
                          _ARGTYPES)


def _resolve_bwd() -> None:
    global _launch_bwd, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch_bwd = _build.load("flash_attention_bwd",
                              "flash_attention_bwd_launch", _BWD_ARGTYPES)


def _head_split(q: torch.Tensor, hkv: int) -> bool:
    """Whether the backward runs dK and dV a block per query head and adds
    each GQA group's sums in a second kernel: bf16 at head_dim 256 with
    GQA, where one block per (b, kv head, 64 keys) leaves SMs idle
    (gemma3's one kv head: 64 blocks at 4,096 tokens on 132 SMs)."""
    return (q.dtype == torch.bfloat16 and q.shape[3] == 256
            and q.shape[1] > hkv)


def _mask(s: int, t: int, causal: bool, window: int | None,
          device) -> torch.Tensor:
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def _plain_fwd(q, k, v, causal, window, scale):
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _mask(s, k.shape[2], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / den
    return out.to(q.dtype), (m + torch.log(den))[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None,
                          return_lse: bool = False):
    """The kernel's function in plain torch, fp32 throughout: one masked
    softmax per row (the kernel's online softmax is this, tile by tile).
    ``return_lse`` also returns each row's fp32 log-sum-exp [B, Hq, Sq]
    (``m + log(max(l, 1e-30))`` of the scaled logits), as the kernel writes
    it for the backward."""
    out, lse = _plain_fwd(q, k, v, causal, window, scale)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None):
    """The backward kernel's function in plain torch, fp32 throughout: P
    recomputed from the forward's ``lse`` under the forward's mask, then
    ``delta = rowsum(dO * O)``, ``dV = P^T dO``, ``dS = P * (dO V^T -
    delta)``, ``dQ = dS K * scale``, ``dK = dS^T Q * scale``, the GQA
    group's dK and dV summed over its query heads.  Returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qf, dof = q.float(), do.float()
    mask = _mask(sq, sk, causal, window, q.device)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, hkv, rep, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, rep, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal, window) -> None:
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    if sk != sq and (causal or window is not None):
        raise ValueError(f"causal or windowed attention needs as many keys "
                         f"as queries, not {sk} for {sq}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, not {window}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must have one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {d}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the bf16 kernel reads 16-byte vectors: rows must start 16-byte aligned
    return (t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format))


def _forward(q, k, v, causal, window, scale, want_lse):
    """(out, lse or None): the kernel on CUDA tensors, the plain version on
    CPU tensors; ``lse`` is written only when ``want_lse``."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        out, lse = _plain_fwd(q, k, v, causal, window, scale)
        return out, (lse if want_lse else None)
    b, hq, sq, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.numel() == 0:
        return out, lse
    if _launch is None:
        _resolve()
    err = _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if want_lse else None, b, hq, k.shape[1],
                  sq, k.shape[2], d, int(causal),
                  -1 if window is None else int(window),
                  float(scale if scale is not None else d ** -0.5),
                  _DTYPES[q.dtype], _raw_stream(q.get_device()))
    if err:
        _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    output ``o``, its rows' fp32 log-sum-exp ``lse`` [B, Hq, Sq] and the
    output's gradient ``do``.  On CUDA tensors: the two kernels of
    ``csrc/flash_attention_bwd.cu`` (three where :func:`_head_split`; one
    launch counted); on CPU tensors :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, causal, window)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(f"bad shapes o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale)
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("o and do take q's dtype, lse float32")
    b, hq, sq, d = q.shape
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    hkv, sk = k.shape[1], k.shape[2]
    part = (torch.empty((2, b * hq, sk, d), dtype=torch.float32,
                        device=q.device)
            if _head_split(q, hkv) else None)
    if _launch_bwd is None:
        _resolve_bwd()
    err = _launch_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                      None if part is None else part.data_ptr(), b, hq,
                      hkv, sq, sk, d, int(causal),
                      -1 if window is None else int(window),
                      float(scale if scale is not None else d ** -0.5),
                      _DTYPES[q.dtype], _raw_stream(q.get_device()))
    if err:
        _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with its gradient: the forward saves q, k, v, the
    output and the rows' log-sum-exp; the backward is
    :func:`flash_attention_bwd` (the kernel on the card, never the plain
    version there)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq % Hkv == 0 and Sk ==
    Sq unless the call is non-causal and unwindowed; returns [B, Hq, Sq, D]
    in q's dtype.  ``window`` is None (global) or >= 1.  Differentiable in
    q, k and v (see :class:`FlashAttentionFn`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, want_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
