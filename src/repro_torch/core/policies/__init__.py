"""Registry-backed compaction policies (the policy/mechanism split).

``LSMTree`` and ``Simulator`` are policy-agnostic mechanism engines; every
compaction decision lives in a :class:`CompactionPolicy` object resolved by
name::

    from repro_torch.core.policies import get_policy, names

    cfg = get_policy("vlsm").default_config(scale=1 << 18)
    names()  # ['vlsm', 'rocksdb', 'rocksdb_io']

Importing this package registers the ported built-in policies in the
reference's canonical order; ``adoc``, ``lsmi`` and ``lazy`` are still to
be ported.
"""

from .base import CompactionPolicy
from .registry import get, names, register

from . import vlsm as _vlsm          # noqa: E402,F401
from . import rocksdb as _rocksdb    # noqa: E402,F401  (rocksdb, rocksdb_io)

get_policy = get

__all__ = ["CompactionPolicy", "get", "get_policy", "names", "register"]
