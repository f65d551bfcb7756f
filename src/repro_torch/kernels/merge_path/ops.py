"""Stable merge of two sorted int64 runs with an int64 seq payload — the
port of the merge_path TPU kernel (``repro/kernels/merge_path/kernel.py``:
``_merge_kernel`` / ``merge_path_call``).  Run A precedes run B on equal
keys, so feeding runs oldest first keeps duplicate keys seq-ascending for
the latest-wins dedup of ``repro_torch.core.merge``.

Every element's output position is its own index plus its rank in the other
run: ``i + #{B < a_i}`` for A, ``j + #{A <= b_j}`` for B.  Keys and seqs are
native int64 (no hi/lo planes, no 2^31 seq limit, no sentinel padding).
On a CUDA tensor :func:`merge_two_runs` launches ``csrc/merge_path.cu``;
on a CPU tensor it runs :func:`merge_two_runs_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..overlap_scan.ops import fence_rank_plain


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


def merge_two_runs(a_keys: torch.Tensor, a_seqs: torch.Tensor,
                   b_keys: torch.Tensor, b_seqs: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable merge of sorted runs A and B (A first on ties)."""
    runs = (a_keys, a_seqs, b_keys, b_seqs)
    if any(t.dtype != torch.int64 or t.dim() != 1 for t in runs):
        raise TypeError("merge_two_runs takes 1-D int64 keys and seqs")
    if a_keys.shape != a_seqs.shape or b_keys.shape != b_seqs.shape:
        raise ValueError("keys and seqs of a run must have one length")
    dev = a_keys.device
    if any(t.device != dev for t in runs):
        raise ValueError("both runs must be on one device")
    if dev.type == "cpu":
        return merge_two_runs_plain(*runs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    a_keys, a_seqs, b_keys, b_seqs = (t.contiguous() for t in runs)
    n_a, n_b = int(a_keys.shape[0]), int(b_keys.shape[0])
    keys = torch.empty(n_a + n_b, dtype=torch.int64, device=dev)
    seqs = torch.empty_like(keys)
    if n_a + n_b == 0:
        return keys, seqs
    fn = _build.load("merge_path", "merge_path_launch",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(a_keys.data_ptr(), a_seqs.data_ptr(), n_a,
             b_keys.data_ptr(), b_seqs.data_ptr(), n_b,
             keys.data_ptr(), seqs.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "merge_path")
    merge_two_runs.launches += 1
    return keys, seqs


merge_two_runs.launches = 0
