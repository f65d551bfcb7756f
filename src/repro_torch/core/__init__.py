"""vLSM core on PyTorch: the compaction-chain-aware LSM KV store and its DES.

Public API::

    from repro_torch.core import (LSMConfig, DeviceModel, LSMTree, Simulator,
                                  OpKind, RequestBatch, ResultBatch,
                                  CompactionPolicy, get_policy, policies)

``LSMTree.apply_batch(RequestBatch) -> ResultBatch`` is the single typed
operation entry point.  ``LSMTree``, ``Simulator``, ``FleetEngine``, the
sweeps (``fleet_sweep``, ``sweep_execute``, ...) and
``repro_torch.bench_kv.ycsb.run_ycsb`` take ``compute_device`` (default
``"cuda"``); ``device`` keeps its reference meaning, the storage
``DeviceModel``.  The legacy ``Policy`` str-enum aliases the five seed
policy names.
"""

from . import policies
from .fleet import (FleetEngine, PendingRun, SweepPoint, fleet_sweep,
                    serial_sweep, traffic_curve)
from .level_index import LevelIndex
from .lsm import Job, LSMTree
from .memtable import Memtable
from .policies import CompactionPolicy, get_policy
from .shard import ShardRouter
from .sim import SimResult, Simulator
from .sst import SST
from .stats import ChainRecord, FleetStats, Stats, TenantLedger
from .sweeps import (DEFAULT_CACHE, LEDGER, ExecutorLedger, PointTiming,
                     StructuralCache, parallel_map, point_key, run_point,
                     serial_sweep_parallel, sweep_execute)
from .types import (DeviceModel, LSMConfig, OpKind, Policy, RequestBatch,
                    ResultBatch, resolve_compute_device)
from .uids import UidNamespace, reset_uid_counters

__all__ = [
    "ChainRecord", "CompactionPolicy", "DEFAULT_CACHE", "DeviceModel",
    "ExecutorLedger", "FleetEngine", "FleetStats", "Job", "LEDGER",
    "LSMConfig", "LSMTree", "LevelIndex", "Memtable", "OpKind",
    "PendingRun", "PointTiming", "Policy", "RequestBatch", "ResultBatch",
    "SST", "ShardRouter", "SimResult", "Simulator", "Stats",
    "StructuralCache", "SweepPoint", "TenantLedger", "UidNamespace",
    "fleet_sweep", "get_policy", "parallel_map", "point_key", "policies",
    "reset_uid_counters", "resolve_compute_device", "run_point",
    "serial_sweep", "serial_sweep_parallel", "sweep_execute",
    "traffic_curve",
]
