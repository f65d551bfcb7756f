"""Single-token attention over a page pool through a page table — the port
of the paged_attention TPU kernel (``repro/kernels/paged_attention/
kernel.py``: ``_paged_kernel`` / ``paged_attention_call``, wrapper
``ops.py``, oracle ``ref.py``).

:func:`paged_attention` takes the reference wrapper's ungrouped
``[B, Hq, D]`` API.  On a CUDA tensor it launches the kernel in
``csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`paged_attention_plain`.  The semantics are the TPU kernel's: the
query heads of one kv head form a group (``h // (Hq / Hkv)``), sequence
``b`` attends the first ``lengths[b]`` tokens of the pages
``page_table[b, 0..]`` (token ``t`` lies in page ``t // PS`` at row
``t % PS``), at most ``MAXP * PS`` of them; logits are fp32 scaled by
``D ** -0.5`` unless given, masked logits are ``-1e30``, masked
probabilities are zeroed and the denominator is clamped at 1e-30, so a
length of 0 gives zeros.

``window`` (gemma3's local layers) keeps only the last ``window`` tokens
of each sequence: with the reference's decode mask ``pos - kj < window``
and ``lengths = pos + 1``, the live tokens are ``[max(0, length - window),
length)``.  ``None`` or a window below 1 means global.

``return_lse`` also returns each output row's fp32 log-sum-exp ``[B, Hq]``,
``m + log(l)`` over the row's live tokens (``NEG_INF`` for a row with
none), as flash_attention's ``return_lse`` does: a sequence-sharded decode
merges the rows that several cache slices give with it
(``distributed/flash_decode.py``).  The output is the same either way.

Page-table entries of pages past a sequence's length, or wholly before its
window, are never read, and neither are the rows of a page outside the
live range: callers may leave garbage there.  The lengths are not checked
on the host (that would synchronise on every call).

The kernel splits each sequence's tokens over several blocks and combines
their partial softmaxes (flash-decoding); :func:`split_plan` picks the
split on the host from the span ``min(MAXP * PS, window)``, ``B * Hkv``,
the card's SM count and the blocks that fit an SM at this head_dim, never
from the device-side lengths.  The card path is
lean, as overlap_scan's is: the C entry is resolved once, the raw current
stream is read without building a ``torch.cuda.Stream``, and contiguous,
16-byte-aligned inputs are passed as they are.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
TILE_TOKENS = 32        # the kernel's tile (kTK): splits are whole tiles
MIN_BLOCKS_PER_SM = 2   # the split gives every SM at least this many blocks
RESIDENT_BLOCKS_PER_SM = 4   # bf16, D 128: 53 KB of shared memory a block
#: blocks a SM holds at head_dim 256, where shared memory allows fewer than
#: RESIDENT_BLOCKS_PER_SM: ~105 KB a block in bf16, ~201 KB in fp32
RESIDENT_BLOCKS_D256 = {torch.bfloat16: 2, torch.float32: 1}
_sm_counts: dict[int, int] = {}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_launch = None       # the C entry, resolved at the first CUDA call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream
# per (device, stream): fp32 scratch for the splits' partials.  Reused only
# on its own stream, where a call's split kernel runs after the previous
# call's combine has read the buffer.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=256)
def split_plan(capacity: int, b: int, hkv: int, n_sm: int,
               resident: int = RESIDENT_BLOCKS_PER_SM) -> tuple[int, int]:
    """(splits, tokens per split) for sequences of up to ``capacity`` live
    tokens (the page table's, or a window's if that is shorter) over a grid
    of ``b * hkv`` (sequence, kv head) pairs on ``n_sm`` SMs, each of which
    holds ``resident`` blocks at once.

    Enough splits that the grid gives every SM ``MIN_BLOCKS_PER_SM`` blocks,
    or as many as fit ``resident`` per SM in one wave if that is more;
    never a split shorter than one tile.  Each split is a whole number of
    tiles and split ``z`` covers live tokens ``[z * per, min((z + 1) * per,
    capacity))`` (counted from the window's first token), so the splits
    cover the capacity exactly, the last one possibly short.  One split
    means no combine pass."""
    tiles = max(1, -(-capacity // TILE_TOKENS))
    pairs = max(1, b * hkv)
    want = max(-(-MIN_BLOCKS_PER_SM * n_sm // pairs),
               resident * n_sm // pairs)
    n = max(1, min(want, tiles))
    per = -(-tiles // n) * TILE_TOKENS
    return max(1, -(-capacity // per)), per


def _resolve() -> None:
    global _launch, _raw_stream
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("paged_attention", "paged_attention_launch",
                          _ARGTYPES)


def _sm_count(idx: int) -> int:
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _partials(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        buf = _scratch[key] = torch.empty(numel, dtype=torch.float32,
                                          device=device)
    return buf


def _window(window: int | None) -> int:
    """The kernel's window argument: 0 for global."""
    return int(window) if window is not None and int(window) > 0 else 0


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          window: int | None = None,
                          scale: float | None = None,
                          return_lse: bool = False):
    """The kernel's function in plain torch, fp32 throughout: gather every
    sequence's pages (entries past its length or wholly before its window
    read page 0 instead), then one masked softmax per query head.  With
    ``return_lse``, ``(out, lse)``."""
    b, hq, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    lengths = lengths.long().clamp(min=0)
    w = _window(window)
    lo = (lengths - w).clamp(min=0) if w else torch.zeros_like(lengths)
    n_pages = (lengths + ps - 1) // ps
    page = torch.arange(maxp, device=q.device)[None, :]
    live = (page < n_pages[:, None]) & (page >= (lo // ps)[:, None])
    pt = torch.where(live, page_table.long(), 0)
    t = maxp * ps
    tok = torch.arange(t, device=q.device)[None, :]
    mask = (tok < lengths[:, None]) & (tok >= lo[:, None])
    k = k_pages[pt].reshape(b, t, hkv, d).float()
    v = v_pages[pt].reshape(b, t, hkv, d).float()
    v = torch.where(mask[:, :, None, None], v, 0.0)
    logits = torch.einsum("bhgd,bthd->bhgt", q.reshape(b, hkv, g, d).float(),
                          k) * scale
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    out = torch.einsum("bhgt,bthd->bhgd", p, v)
    den = p.sum(dim=-1, keepdim=True)
    out = (out / torch.clamp(den, min=1e-30)).reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(den > 0, m + torch.log(den), NEG_INF)
    return out, lse.reshape(b, hq)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *, window: int | None = None,
                    scale: float | None = None, return_lse: bool = False):
    """q: [B, Hq, D]; k_pages, v_pages: [NP, PS, Hkv, D] with Hq % Hkv == 0;
    page_table: [B, MAXP] int32; lengths: [B] int32; ``window``: None (or
    < 1) for global, else the last ``window`` tokens.  Returns [B, Hq, D]
    in q's dtype, and with ``return_lse`` also the rows' fp32 log-sum-exp
    [B, Hq]."""
    b, hq, d = q.shape
    n_pages, ps, hkv = k_pages.shape[:3]
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if (k_pages.shape != (n_pages, ps, hkv, d) or v_pages.shape !=
            k_pages.shape or hkv == 0 or hq % hkv or page_table.shape !=
            (b, maxp) or lengths.shape != (b,) or n_pages == 0):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}, page_table {tuple(page_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("q and the pages must have one dtype")
    if not (q.device == k_pages.device == v_pages.device == page_table.device
            == lengths.device):
        raise ValueError("all arguments must be on one device")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, window=window, scale=scale,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head, not {d} and {hq // hkv}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    # the kernel reads 16-byte vectors: rows must start 16-byte aligned
    q, k_pages, v_pages = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k_pages, v_pages))
    if not page_table.is_contiguous():
        page_table = page_table.contiguous()
    if not lengths.is_contiguous():
        lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    if _launch is None:
        _resolve()
    dev = q.get_device()
    w = _window(window)
    span = min(maxp * ps, w) if w else maxp * ps
    ns, per = split_plan(span, b, hkv, _sm_count(dev),
                         RESIDENT_BLOCKS_D256[q.dtype] if d == 256
                         else RESIDENT_BLOCKS_PER_SM)
    stream = _raw_stream(dev)
    # per split and output row: m and l, then the unnormalised acc
    part = _partials(q.device, stream, b * hq * ns * (d + 2)) \
        if ns > 1 else None
    err = _launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, hq, hkv, d,
                  ps, maxp, ns, per,
                  float(scale if scale is not None else d ** -0.5), w,
                  _DTYPES[q.dtype], stream)
    if err:
        _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


paged_attention.launches = 0
