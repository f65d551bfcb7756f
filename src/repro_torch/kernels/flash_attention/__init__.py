"""Causal / sliding-window online-softmax attention: the port of the
flash_attention TPU kernel."""

from .ops import flash_attention, flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]
