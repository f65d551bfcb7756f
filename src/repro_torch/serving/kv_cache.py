"""Paged KV-cache pool for serving — the port of
``repro/serving/kv_cache.py``.

Pages are fixed-size token blocks ([PS, Hkv, Dh] per layer) held on the
compute device; sequences own page lists.  The LSM-backed prefix cache
(``prefix_cache.py``) pins shared pages.  As in the reference's serve loop,
these pages are allocated and registered but not read: decode runs the
paged_attention kernel over each request's dense decode cache, viewed as
pages through an identity page table (``models.attention.attn_decode``),
not over this pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.types import resolve_compute_device
from ..models.common import DTYPES


@dataclass
class PagePool:
    n_pages: int
    page_size: int
    n_layers: int
    n_kv_heads: int
    head_dim: int
    dtype: str = "float32"
    compute_device: str | torch.device = "cuda"
    k_pages: torch.Tensor = field(init=False)   # [L, NP, PS, Hkv, Dh]
    v_pages: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.compute_device = resolve_compute_device(self.compute_device)
        shape = (self.n_layers, self.n_pages, self.page_size,
                 self.n_kv_heads, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=DTYPES[self.dtype],
                                   device=self.compute_device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.refcount = np.zeros(self.n_pages, np.int32)

    # ------------------------------------------------------------- alloc
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("page pool exhausted")
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    def pin(self, page: int) -> None:
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        self.refcount[page] -= 1
        if self.refcount[page] <= 0:
            self.refcount[page] = 0
            self._free.append(page)

    # ------------------------------------------------------------- write
    def write_tokens(self, layer: int, page: int, offset: int,
                     k: torch.Tensor, v: torch.Tensor) -> None:
        """k, v: [T, Hkv, Dh] with offset+T <= page_size (in place)."""
        if offset + k.shape[0] > self.page_size:
            raise ValueError("write past the end of the page")
        self.k_pages[layer, page, offset:offset + k.shape[0]] = k
        self.v_pages[layer, page, offset:offset + v.shape[0]] = v


@dataclass
class Sequence:
    seq_id: int
    tokens: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)
    length: int = 0
    shared_prefix_len: int = 0

    def pages_needed(self, page_size: int, new_tokens: int) -> int:
        have = len(self.pages) * page_size
        need = self.length + new_tokens
        return max(0, -(-(need - have) // page_size))
