"""Mamba2 SSD chunked scan: the port of the ssd_scan TPU kernel."""

from .ops import ssd_scan, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain"]
