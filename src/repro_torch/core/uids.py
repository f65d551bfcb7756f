"""Explicit uid namespaces: per-engine SST/job/chain id streams.

SST uids seed the bloom false-positive hash, so two engines replaying the
same op stream are byte-identical only when their uid streams match.
:class:`UidNamespace` gives an engine its own three counters starting at
zero — the state :func:`reset_uid_counters` rewinds the module-global
counters to — so either idiom reproduces the reference's streams bit for
bit.
"""

from __future__ import annotations

import itertools


class UidNamespace:
    """One engine's private uid streams (SST / job / chain counters)."""

    __slots__ = ("sst_ids", "job_ids", "chain_ids")

    def __init__(self) -> None:
        self.sst_ids = itertools.count()
        self.job_ids = itertools.count()
        self.chain_ids = itertools.count()

    def __reduce__(self):
        return (UidNamespace, ())


def reset_uid_counters() -> None:
    """Rewind the module-level SST/job/chain uid counters (for engines
    built without a namespace: slot-0 trees draw SST uids from them)."""
    from . import lsm as _lsm
    from . import sst as _sst
    _sst._ids = itertools.count()
    _lsm._job_ids = itertools.count()
    _lsm._chain_ids = itertools.count()
