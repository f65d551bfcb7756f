"""Causal or sliding-window attention with an online softmax — the port of
the flash_attention TPU kernel (``repro/kernels/flash_attention/kernel.py``:
``_flash_kernel`` / ``flash_attention_call``, wrapper ``ops.py``).

:func:`flash_attention` takes the reference wrapper's ``[B, H, S, D]`` API.
On a CUDA tensor it launches the kernel in ``csrc/flash_attention.cu``; on
a CPU tensor it runs :func:`flash_attention_plain`.  bf16 inputs take the
kernel's tensor-core path, fp32 inputs its fp32 CUDA-core path.  The card
path is lean, as overlap_scan's is: the C entry is resolved once, the raw
current stream is read without building a ``torch.cuda.Stream``, and
inputs that are contiguous and 16-byte aligned are passed as they are.
Two things differ from the reference's wrapper and change no output:

* GQA: the kernel maps each query head to its kv head (``h // rep``)
  instead of materialising ``repeat``ed k and v;
* no padding of S to the block: the kernel masks keys past S itself, so
  non-causal calls of any length work too (the reference asserts there).

The semantics are the TPU kernel's: masked logits are ``-1e30`` (not -inf),
masked probabilities are zeroed, the denominator is clamped at 1e-30 (a
fully masked row gives 0), the scale is ``D ** -0.5`` unless given, and the
window keeps keys with ``qi - kj < window``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_launch = None       # the C entry, resolved at the first CUDA call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


def _resolve() -> None:
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("flash_attention", "flash_attention_launch",
                          _ARGTYPES)


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch, fp32 throughout: one masked
    softmax per row (the kernel's online softmax is this, tile by tile)."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] with Hq % Hkv == 0; returns
    [B, Hq, S, D] in q's dtype.  ``window`` is None (global) or >= 1."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, not {window}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must have one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {d}")
    # the bf16 kernel reads 16-byte vectors: rows must start 16-byte aligned
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if _launch is None:
        _resolve()
    err = _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, s, d, int(causal),
                  -1 if window is None else int(window),
                  float(scale if scale is not None else d ** -0.5),
                  _DTYPES[q.dtype], _raw_stream(q.get_device()))
    if err:
        _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
