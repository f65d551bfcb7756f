"""Single-token attention over a page pool through a page table: the port
of the paged_attention TPU kernel."""

from .ops import paged_attention, paged_attention_plain

__all__ = ["paged_attention", "paged_attention_plain"]
