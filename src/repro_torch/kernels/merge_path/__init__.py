"""Stable two-run merge: the port of the merge_path TPU kernel."""

from .ops import merge_two_runs, merge_two_runs_plain

__all__ = ["merge_two_runs", "merge_two_runs_plain"]
