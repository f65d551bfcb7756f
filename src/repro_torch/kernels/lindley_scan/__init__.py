"""Batched Lindley recursion: the port of the lindley_scan TPU kernel."""

from .ops import TILE, lindley_batch, lindley_batch_plain

__all__ = ["TILE", "lindley_batch", "lindley_batch_plain"]
