"""vLSM core on PyTorch: the compaction-chain-aware LSM KV store and its DES.

Public API::

    from repro_torch.core import (LSMConfig, DeviceModel, LSMTree, Simulator,
                                  OpKind, RequestBatch, ResultBatch,
                                  CompactionPolicy, get_policy, policies)

``LSMTree.apply_batch(RequestBatch) -> ResultBatch`` is the single typed
operation entry point.  ``LSMTree``, ``Simulator`` and
``repro_torch.bench_kv.ycsb.run_ycsb`` take ``compute_device`` (default
``"cuda"``); ``device`` keeps its reference meaning, the storage
``DeviceModel``.
"""

from . import policies
from .level_index import LevelIndex
from .lsm import Job, LSMTree
from .memtable import Memtable
from .policies import CompactionPolicy, get_policy
from .shard import ShardRouter
from .sim import SimResult, Simulator
from .sst import SST
from .stats import ChainRecord, FleetStats, Stats, TenantLedger
from .types import (DeviceModel, LSMConfig, OpKind, RequestBatch,
                    ResultBatch, resolve_compute_device)
from .uids import UidNamespace, reset_uid_counters

__all__ = [
    "ChainRecord", "CompactionPolicy", "DeviceModel", "FleetStats", "Job",
    "LSMConfig", "LSMTree", "LevelIndex", "Memtable", "OpKind",
    "RequestBatch", "ResultBatch", "SST", "ShardRouter", "SimResult",
    "Simulator", "Stats", "TenantLedger", "UidNamespace", "get_policy",
    "policies", "reset_uid_counters", "resolve_compute_device",
]
