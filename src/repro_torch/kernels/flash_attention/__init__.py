"""Causal / sliding-window / non-causal online-softmax attention and its
gradient: the port of the flash_attention TPU kernel."""

from .ops import (FlashAttentionFn, flash_attention, flash_attention_bwd,
                  flash_attention_bwd_plain, flash_attention_plain)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain"]
