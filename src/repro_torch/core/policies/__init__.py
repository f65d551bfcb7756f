"""Registry-backed compaction policies (the policy/mechanism split).

``LSMTree`` and ``Simulator`` are policy-agnostic mechanism engines; every
compaction decision lives in a :class:`CompactionPolicy` object resolved by
name::

    from repro_torch.core.policies import get_policy, names

    cfg = get_policy("vlsm").default_config(scale=1 << 18)
    names()  # ['vlsm', 'rocksdb', 'rocksdb_io', 'adoc', 'lsmi', 'lazy']

Importing this package registers the six built-in policies in the
reference's canonical order, the order bench rows come out in.
"""

from .base import CompactionPolicy
from .registry import (default_configs, get, names, register,
                       resolve_names)

# canonical order: the paper's Fig 3 designs, then lazy leveling
from . import vlsm as _vlsm          # noqa: E402,F401
from . import rocksdb as _rocksdb    # noqa: E402,F401  (rocksdb, rocksdb_io)
from . import adoc as _adoc          # noqa: E402,F401
from . import lsmi as _lsmi          # noqa: E402,F401
from . import lazy as _lazy          # noqa: E402,F401

get_policy = get

__all__ = ["CompactionPolicy", "default_configs", "get", "get_policy",
           "names", "register", "resolve_names"]
