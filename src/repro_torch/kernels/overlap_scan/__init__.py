"""Sorted-array rank: the port of the overlap_scan TPU kernel."""

from .ops import (fence_rank, fence_rank_plain, lookup_probe,
                  lookup_probe_plain)

__all__ = ["fence_rank", "fence_rank_plain", "lookup_probe",
           "lookup_probe_plain"]
