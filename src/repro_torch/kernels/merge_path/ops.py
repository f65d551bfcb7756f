"""Stable merge of two sorted int64 runs with an int64 seq payload — the
port of the merge_path TPU kernel (``repro/kernels/merge_path/kernel.py``:
``_merge_kernel`` / ``merge_path_call``).  Run A precedes run B on equal
keys, so feeding runs oldest first keeps duplicate keys seq-ascending for
the latest-wins dedup of ``repro_torch.core.merge``.

Every element's output position is its own index plus its rank in the other
run: ``i + #{B < a_i}`` for A, ``j + #{A <= b_j}`` for B.  Keys and seqs are
native int64 (no hi/lo planes, no 2^31 seq limit, no sentinel padding).
On a CUDA tensor :func:`merge_two_runs` launches ``csrc/merge_path.cu``
(merge-path tiles staged in shared memory); on a CPU tensor it runs
:func:`merge_two_runs_plain`.  The store calls it hundreds of times a
replay, so the card path is kept lean as overlap_scan's is: the C entry is
resolved once, the raw current stream is read without building a
``torch.cuda.Stream``, the inputs are checked in one expression each for
dtype, rank and device, and contiguous inputs are passed as they are.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..overlap_scan.ops import fence_rank_plain

TILE = 1024          # outputs of a block: the kernel's kTile, checked at load
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_launch = None       # the C entry, resolved at the first CUDA call
_raw_stream = None   # torch._C._cuda_getCurrentRawStream


def merge_two_runs_plain(a_keys: torch.Tensor, a_seqs: torch.Tensor,
                         b_keys: torch.Tensor, b_seqs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same positions computed with the plain rank, then scattered."""
    n_a, n_b = int(a_keys.shape[0]), int(b_keys.shape[0])
    dev = a_keys.device
    pos_a = torch.arange(n_a, device=dev) + fence_rank_plain(b_keys, a_keys,
                                                             "left")
    pos_b = torch.arange(n_b, device=dev) + fence_rank_plain(a_keys, b_keys,
                                                             "right")
    keys = torch.empty(n_a + n_b, dtype=torch.int64, device=dev)
    seqs = torch.empty_like(keys)
    keys[pos_a] = a_keys
    keys[pos_b] = b_keys
    seqs[pos_a] = a_seqs
    seqs[pos_b] = b_seqs
    return keys, seqs


def _resolve() -> None:
    global _launch, _raw_stream
    tile = _build.load("merge_path", "merge_path_tile", [])()
    if tile != TILE:
        raise RuntimeError(f"merge_path: the library's tile is {tile}, "
                           f"ops.TILE {TILE}")
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _launch = _build.load("merge_path", "merge_path_launch", _ARGTYPES)


def merge_two_runs(a_keys: torch.Tensor, a_seqs: torch.Tensor,
                   b_keys: torch.Tensor, b_seqs: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable merge of sorted runs A and B (A first on ties)."""
    if not (a_keys.dtype is a_seqs.dtype is b_keys.dtype is b_seqs.dtype
            is torch.int64 and a_keys.dim() == a_seqs.dim() == b_keys.dim()
            == b_seqs.dim() == 1):
        raise TypeError("merge_two_runs takes 1-D int64 keys and seqs")
    n_a, n_b = a_keys.numel(), b_keys.numel()
    if a_seqs.numel() != n_a or b_seqs.numel() != n_b:
        raise ValueError("keys and seqs of a run must have one length")
    dev = a_keys.get_device()
    if dev < 0:
        runs = (a_keys, a_seqs, b_keys, b_seqs)
        if any(t.device != a_keys.device for t in runs):
            raise ValueError("both runs must be on one device")
        if a_keys.device.type != "cpu":
            raise ValueError(f"unsupported device {a_keys.device}")
        return merge_two_runs_plain(*runs)
    if not dev == a_seqs.get_device() == b_keys.get_device() \
            == b_seqs.get_device():
        raise ValueError("both runs must be on one device")
    if not a_keys.is_contiguous():
        a_keys = a_keys.contiguous()
    if not a_seqs.is_contiguous():
        a_seqs = a_seqs.contiguous()
    if not b_keys.is_contiguous():
        b_keys = b_keys.contiguous()
    if not b_seqs.is_contiguous():
        b_seqs = b_seqs.contiguous()
    n = n_a + n_b
    keys, seqs = a_keys.new_empty(n), a_keys.new_empty(n)
    if n:
        if _launch is None:
            _resolve()
        err = _launch(a_keys.data_ptr(), a_seqs.data_ptr(), n_a,
                      b_keys.data_ptr(), b_seqs.data_ptr(), n_b,
                      keys.data_ptr(), seqs.data_ptr(), _raw_stream(dev))
        if err:
            _build.check(err, "merge_path")
        merge_two_runs.launches += 1
    return keys, seqs


merge_two_runs.launches = 0
