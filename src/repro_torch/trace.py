"""Named spans of the DES's and the store's work, recorded by whichever
``torch.profiler`` (or autograd profiler) is recording.

``span(name)`` is a context manager.  While a profiler records, it is
``torch.profiler.record_function(name)``: the range lands in the
profiler's trace as a ``user_annotation`` event, on the same clock as the
device's kernels and copies, nested inside the spans around it.  While
none records, it is one shared no-op context, and a span costs a flag read
and a ``with`` statement.  There is no other recorder and no switch: run
the store under ``torch.profiler.profile`` to see its spans.

Spans mark layer boundaries (a fill event, a flush, a compaction chain, a
merge, a GET batch), never the body of a per-op or per-key loop.  They
nest on the one thread that drives the store, so the enclosing span is
the one that caused a span.  The names are ``des.*`` for the DES
(:mod:`repro_torch.core.sim`) and ``store.*`` for the store's mechanism
and policies; README.md lists them.

This module imports nothing of ``repro_torch``: any layer, the kernels
included, may use it.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else the
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
