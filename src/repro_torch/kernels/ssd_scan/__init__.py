"""Mamba2 SSD chunked scan: the port of the ssd_scan TPU kernel, and its
gradient."""

from .ops import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_plain", "ssd_scan_plain"]
