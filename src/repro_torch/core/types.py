"""Core types of the vLSM store: the typed operation API and configuration.

Two groups live here, as in the reference (``repro.core.types``):

* **The operation surface** — :class:`OpKind` (PUT/GET/DELETE/SCAN), the
  columnar :class:`RequestBatch` (kinds / keys / scan_lens / seqnos as flat
  numpy arrays) and :class:`ResultBatch`.  Batches are host-side request
  and result buffers: ``LSMTree.apply_batch`` moves the keys to the compute
  device and brings the per-op results back in one transfer.

* **Configuration dataclasses** — all sizes in *bytes*; the canned
  configurations come from the registered compaction policies.

Two devices
-----------

``device`` keeps the reference's meaning everywhere: the *storage*
:class:`DeviceModel` (bandwidths, latencies, compaction slots) the DES
charges time against.  The torch device the store's arrays live on is
``compute_device`` (default ``"cuda"``), resolved by
:func:`resolve_compute_device`, which refuses to fall back to the CPU
silently when no GPU is present.

Tombstone encoding
------------------

DELETE writes a *tombstone*: a normal (key, seq) entry whose seqno carries a
tag bit — ``enc = (seq << 1) | is_tombstone``.  The encoding is monotone in
``seq``, so every latest-wins merge works on encoded seqnos unchanged;
:func:`seq_decode` strips the tag at every user-visible boundary.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from dataclasses import dataclass, field

import numpy as np
import torch


def _paranoid_default() -> bool:
    """Default for ``LSMConfig.paranoid_checks``: the test suite turns it
    on via ``REPRO_PARANOID_CHECKS=1`` (tests/conftest.py); benchmarks and
    production paths leave it off."""
    return os.environ.get("REPRO_PARANOID_CHECKS", "0") == "1"


def resolve_compute_device(compute_device: str | torch.device) -> torch.device:
    """The torch device a store or simulator keeps its arrays on.

    ``"cuda"`` (the default of every entry point) requires a visible GPU
    and raises otherwise: the CPU tier runs only when asked for by name.
    """
    dev = torch.device(compute_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "compute_device='cuda' but torch sees no CUDA device; pass "
            "compute_device='cpu' to run the plain PyTorch tier")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported compute_device {compute_device!r}")
    return dev


class OpKind(enum.IntEnum):
    """Typed KV operations.  PUT/GET keep the legacy 0/1 wire values."""

    PUT = 0
    GET = 1
    DELETE = 2
    SCAN = 3


def seq_encode(seqs: np.ndarray, tombstone) -> np.ndarray:
    """Tag logical seqnos with the tombstone bit (monotone in ``seqs``).
    Seqnos are assigned on the host, so the encoding is numpy."""
    return (np.asarray(seqs, np.int64) << 1) | np.asarray(tombstone, np.int64)


def seq_decode(enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split encoded seqnos (a device tensor) into ``(logical_seq,
    is_tombstone)``."""
    return enc >> 1, (enc & 1).to(torch.bool)


@dataclass
class RequestBatch:
    """A columnar batch of typed KV operations (the store's request ABI).

    ``kinds[i]`` is an :class:`OpKind` value; ``keys[i]`` is the op's key
    (a SCAN's *start* key); ``scan_lens[i]`` is the number of live keys a
    SCAN returns (0 for other kinds); ``seqnos[i]`` is the logical seqno
    the engine assigned to a PUT/DELETE (-1 until applied).
    """

    kinds: np.ndarray                       # uint8, OpKind values
    keys: np.ndarray                        # int64
    scan_lens: np.ndarray | None = None     # int32; lazily zeros
    seqnos: np.ndarray | None = None        # int64; lazily -1

    def __post_init__(self) -> None:
        self.kinds = np.ascontiguousarray(self.kinds, np.uint8)
        self.keys = np.ascontiguousarray(self.keys, np.int64)
        n = self.kinds.shape[0]
        assert self.keys.shape[0] == n, "kinds/keys length mismatch"
        if self.scan_lens is None:
            self.scan_lens = np.zeros(n, np.int32)
        else:
            self.scan_lens = np.ascontiguousarray(self.scan_lens, np.int32)
            assert self.scan_lens.shape[0] == n
        if self.seqnos is None:
            self.seqnos = np.full(n, -1, np.int64)
        else:
            self.seqnos = np.ascontiguousarray(self.seqnos, np.int64)
            assert self.seqnos.shape[0] == n
        scans = self.kinds == OpKind.SCAN
        assert (self.scan_lens[scans] > 0).all(), "SCAN needs scan_lens > 0"

    def __len__(self) -> int:
        return int(self.kinds.shape[0])

    def mask(self, *kinds: OpKind) -> np.ndarray:
        m = np.zeros(len(self), bool)
        for k in kinds:
            m |= self.kinds == k
        return m

    # --- constructors -----------------------------------------------------
    @staticmethod
    def puts(keys: np.ndarray) -> "RequestBatch":
        keys = np.asarray(keys, np.int64)
        return RequestBatch(np.full(keys.shape[0], OpKind.PUT, np.uint8), keys)

    @staticmethod
    def gets(keys: np.ndarray) -> "RequestBatch":
        keys = np.asarray(keys, np.int64)
        return RequestBatch(np.full(keys.shape[0], OpKind.GET, np.uint8), keys)

    @staticmethod
    def deletes(keys: np.ndarray) -> "RequestBatch":
        keys = np.asarray(keys, np.int64)
        return RequestBatch(np.full(keys.shape[0], OpKind.DELETE, np.uint8),
                            keys)

    @staticmethod
    def scans(start_keys: np.ndarray, lengths: np.ndarray) -> "RequestBatch":
        start_keys = np.asarray(start_keys, np.int64)
        return RequestBatch(
            np.full(start_keys.shape[0], OpKind.SCAN, np.uint8),
            start_keys, scan_lens=np.asarray(lengths, np.int32))


@dataclass
class ResultBatch:
    """Aligned, columnar results for one :class:`RequestBatch` (host numpy).

    ``seqs[i]``: PUT/DELETE → the assigned logical seqno; GET → the found
    logical seqno or -1 (missing *or deleted*); SCAN → number of live keys
    returned.  ``reads``/``probed`` are device block reads and SSTs touched
    (nonzero only for read kinds).  SCAN payloads are flattened into
    ``scan_keys``/``scan_seqs``; op *i* owns the half-open slice
    ``scan_offsets[i]:scan_offsets[i+1]`` (zero-width for non-scans).
    """

    kinds: np.ndarray
    seqs: np.ndarray
    reads: np.ndarray
    probed: np.ndarray
    scan_offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))
    scan_keys: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))
    scan_seqs: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int64))

    def __len__(self) -> int:
        return int(self.kinds.shape[0])

    def scan_slice(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(keys, logical seqs) returned by op ``i`` (empty for non-scans)."""
        a, b = int(self.scan_offsets[i]), int(self.scan_offsets[i + 1])
        return self.scan_keys[a:b], self.scan_seqs[a:b]


class Policy(str, enum.Enum):
    """Aliases for the five seed compaction policies (Fig. 3).

    ``LSMConfig.policy`` carries a plain registry name; these members
    compare equal to those names (``cfg.policy == Policy.VLSM``) and are
    accepted wherever a name is (``LSMConfig(policy=Policy.ADOC)``,
    ``policies.get(Policy.LSMI)``).  Policies registered later, such as
    ``"lazy"``, have a name and no member.
    """

    VLSM = "vlsm"            # Fig 3(d): no tiering, small SSTs, phi, vSSTs
    ROCKSDB = "rocksdb"      # Fig 3(b): tiering L0 + leveled rest + debt
    ROCKSDB_IO = "rocksdb_io"  # RocksDB with overflow (debt) disabled
    ADOC = "adoc"            # Fig 3(c): tiering + debt + aggressive scheduling
    LSMI = "lsmi"            # Fig 3(a): incremental, no tiering, fixed SSTs


@dataclass(frozen=True)
class DeviceModel:
    """Deterministic storage-device model (replaces the paper's NVMe).

    Defaults approximate the paper's Samsung 970 EVO Plus.  This is the
    *storage* device the DES charges; the torch device is the separate
    ``compute_device`` argument of the entry points.
    """

    write_bw: float = 2.0e9       # sequential write bytes/s
    read_bw: float = 3.5e9        # sequential read bytes/s
    io_latency: float = 100e-6    # per-I/O setup latency (seconds)
    block_size: int = 4096        # read granularity for point lookups
    compaction_slots: int = 4     # background compaction/flush threads

    def write_time(self, nbytes: int, n_ios: int = 1) -> float:
        return nbytes / self.write_bw + n_ios * self.io_latency

    def read_time(self, nbytes: int, n_ios: int = 1) -> float:
        return nbytes / self.read_bw + n_ios * self.io_latency

    @staticmethod
    def scaled(lam: float) -> "DeviceModel":
        """Device matched to a data scale ``lam = scale_bytes / 64 MiB``:
        bandwidth scales with the data while per-IO latency stays constant."""
        return DeviceModel(write_bw=2.0e9 * lam, read_bw=3.5e9 * lam)


@dataclass(frozen=True)
class LSMConfig:
    # --- data shape -------------------------------------------------------
    kv_size: int = 200                  # bytes per KV pair (paper §5: 200 B)
    # --- memory component -------------------------------------------------
    memtable_size: int = 1 << 20        # bytes; == SST size, as in the paper
    max_write_buffers: int = 2          # active + immutable (RocksDB default)
    # --- on-device layout -------------------------------------------------
    sst_size: int = 1 << 20             # S_M, the fixed SST size
    l0_max_ssts: int = 4                # L0 compaction trigger (RocksDB: 4)
    l0_stop_ssts: int = 8               # hard write-stop L0 file count
    growth_factor: int = 8              # f across levels
    phi: int = 32                       # vLSM growth factor L1 -> L2
    max_levels: int = 5                 # L0..L4
    # --- policy -----------------------------------------------------------
    policy: str = "vlsm"                # registry name (repro_torch.core.policies)
    debt_factor: float = 0.0            # allowed overflow fraction per level
    adoc_batch: int = 4                 # SSTs per compaction job under ADOC
    # --- vSST policy (§4.2) -----------------------------------------------
    vsst_min_frac: float | None = None  # S_m = S_M * frac; default 1/f
    # --- lookup model -----------------------------------------------------
    bloom_fpr: float = 0.01             # bloom-filter false-positive rate
    block_size: int = 4096              # device read granularity for scans
    # --- sharding ---------------------------------------------------------
    n_shards: int = 1
    shard_router: str = "hash"          # "hash" | "range"
    shard_key_space: int = 1 << 48
    # chain-aware background scheduling (False: legacy FIFO drain order)
    chain_aware_sched: bool = True
    # run LSMTree.check_invariants() on every drain_jobs()
    paranoid_checks: bool = field(default_factory=_paranoid_default)

    def __post_init__(self) -> None:
        # a Policy member becomes its registry name
        object.__setattr__(self, "policy",
                           getattr(self.policy, "value", self.policy))
        assert self.n_shards >= 1, "n_shards must be >= 1"
        assert self.shard_router in ("hash", "range"), \
            f"unknown shard_router {self.shard_router!r} (hash|range)"

    # ----------------------------------------------------------------------
    @property
    def s_m(self) -> int:
        """Minimum vSST size S_m (paper: S_M / f)."""
        frac = self.vsst_min_frac if self.vsst_min_frac is not None else 1.0 / self.growth_factor
        return max(self.kv_size, int(self.sst_size * frac))

    @property
    def s_M(self) -> int:
        return self.sst_size

    @property
    def keys_per_sst(self) -> int:
        return max(1, self.sst_size // self.kv_size)

    @property
    def keys_per_memtable(self) -> int:
        return max(1, self.memtable_size // self.kv_size)

    def compaction_policy(self):
        """The registry-resolved CompactionPolicy strategy object."""
        from .policies import get_policy  # lazy: policies import this module
        return get_policy(self.policy)

    @property
    def tiering(self) -> bool:
        return self.compaction_policy().tiering_l0

    def level_target(self, level: int) -> int:
        return self.compaction_policy().level_target(self, level)

    def level_limit(self, level: int) -> int:
        return self.compaction_policy().level_limit(self, level)

    def with_(self, **kw) -> "LSMConfig":
        return dataclasses.replace(self, **kw)

    # --- canned configurations (delegates to the registry) ----------------
    @staticmethod
    def rocksdb_default(scale: int = 1 << 20) -> "LSMConfig":
        from .policies import get_policy
        return get_policy("rocksdb").default_config(scale)

    @staticmethod
    def rocksdb_io_default(scale: int = 1 << 20) -> "LSMConfig":
        from .policies import get_policy
        return get_policy("rocksdb_io").default_config(scale)

    @staticmethod
    def adoc_default(scale: int = 1 << 20) -> "LSMConfig":
        from .policies import get_policy
        return get_policy("adoc").default_config(scale)

    @staticmethod
    def vlsm_default(scale: int = 1 << 20, sst_frac: int = 8) -> "LSMConfig":
        from .policies import get_policy
        return get_policy("vlsm").default_config(scale, sst_frac=sst_frac)

    @staticmethod
    def lsmi_default(scale: int = 1 << 20) -> "LSMConfig":
        from .policies import get_policy
        return get_policy("lsmi").default_config(scale)
