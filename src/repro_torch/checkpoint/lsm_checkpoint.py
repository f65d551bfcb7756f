"""Incremental LSM checkpointing — the paper's design applied to training
fault tolerance; the port of ``repro/checkpoint/lsm_checkpoint.py``.

Every ``save`` splits each leaf of a state dict into fixed-size pages,
hashes them, and writes ONLY the changed pages to an append-only segment
file (the "flush").  Page→version mappings go through the port's own
:class:`~repro_torch.core.LSMTree` running the **vLSM policy** on
``compute_device`` (its rank and merge calls are the overlap_scan and
merge_path kernels on the card): small SSTs, no tiering, Φ between L1/L2,
overlap-aware vSSTs — so the index's compaction chains stay narrow and the
number of live segments a restore must touch stays bounded.  Dead segments
are reference-counted and garbage-collected as compaction supersedes their
entries.

Leaves are named and ordered as the reference names them (its
``jax.tree_util`` key paths joined with ``/``, dict keys in sorted order),
so page ids, manifests and segment contents are the reference's for the
same values.  A leaf may be a tensor on any device, a numpy array or a
scalar; bf16 tensors are stored as their raw 16-bit words with dtype
``"bfloat16"`` in the manifest (the reference's bytes, without ml_dtypes).
``restore`` returns tensors, ``.to(compute_device)`` where one is given;
under a ``DeviceMesh`` and a spec tree (``distributed.sharding``) every
rank reads only the pages that hold its own shard of each leaf and returns
DTensors built from those shards with no collective: the reference's
``device_put`` under shardings.  Restoring under another mesh than the one
that saved is the elastic reshard.  ``async_save`` copies CUDA tensors to
the host on the calling thread and serialises off it.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import threading
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core import LSMConfig, LSMTree
from ..distributed.sharding import axis_sizes, local_slice, placements
from ..training.tree import leaf_paths, unflatten_like

PAGE_BYTES = 1 << 18   # 256 KiB logical pages
_BF16 = "bfloat16"


def _leaf_names(tree) -> tuple[list[str], list]:
    flat = leaf_paths(tree)
    return ["/".join(str(k) for k in path) for path, _ in flat], \
        [leaf for _, leaf in flat]


def _host(x) -> tuple[np.ndarray, str]:
    """(host array, dtype name): a bf16 tensor as its raw 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _tensor(buf: bytearray, dtype: str, shape: list) -> torch.Tensor:
    if dtype == _BF16:
        arr = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype))
                            .reshape(shape))


def _itemsize(dtype: str) -> int:
    return 2 if dtype == _BF16 else np.dtype(dtype).itemsize


def _slice_runs(ranges, shape, itemsize: int) -> tuple[list[int], int]:
    """The box ``ranges`` ([start, stop) a dimension) of a C-ordered leaf of
    ``shape`` as runs of contiguous bytes: (each run's byte offset in the
    leaf, in the box's own C order, which is ascending; the bytes of a
    run)."""
    if any(b <= a for a, b in ranges):
        return [], 0
    # dimensions from k on are whole, so each run spans dimension k - 1's
    # range times their product
    k = len(shape)
    while k > 0 and ranges[k - 1] == (0, shape[k - 1]):
        k -= 1
    inner = math.prod(shape[k:])
    if k == 0:
        return [0], inner * itemsize
    lo, hi = ranges[k - 1]
    strides = [math.prod(shape[i + 1:k]) * inner for i in range(k - 1)]
    runs = [(sum(i * st for i, st in zip(idx, strides)) + lo * inner)
            * itemsize
            for idx in itertools.product(*(range(a, b)
                                           for a, b in ranges[:k - 1]))]
    return runs, (hi - lo) * inner * itemsize


class LSMCheckpointStore:
    def __init__(self, root: str | Path, *, page_bytes: int = PAGE_BYTES,
                 lsm_cfg: LSMConfig | None = None,
                 compute_device: str | torch.device = "cuda"):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "segments").mkdir(exist_ok=True)
        self.page_bytes = page_bytes
        # the version index: key = page_id, seq = monotonically increasing
        # write id; vLSM policy per the paper.
        self.index = LSMTree(lsm_cfg or LSMConfig.vlsm_default(scale=1 << 18)
                             .with_(kv_size=64),
                             compute_device=compute_device)
        # seq -> (segment, leaf, page)
        self.locator: dict[int, tuple[str, str, int]] = {}
        self.page_hash: dict[int, bytes] = {}
        self.seg_live: dict[str, int] = {}
        self.steps: dict[int, dict] = {}
        self._leaf_ids: dict[str, int] = {}
        # monotonic per-store segment sequence: segment names are unique
        # and deterministic across reruns
        self._seg_seq = 0
        self._lock = threading.Lock()
        self._pending: list[threading.Thread] = []
        self._load_manifest()

    # ------------------------------------------------------------ manifest
    def _manifest_path(self) -> Path:
        return self.root / "MANIFEST.json"

    def _save_manifest(self):
        m = {
            "locator": {str(k): v for k, v in self.locator.items()},
            "steps": {str(k): v for k, v in self.steps.items()},
            "leaf_ids": self._leaf_ids,
            "seg_live": self.seg_live,
        }
        tmp = self._manifest_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(m))
        tmp.replace(self._manifest_path())

    def _load_manifest(self):
        p = self._manifest_path()
        if not p.exists():
            return
        m = json.loads(p.read_text())
        self.locator = {int(k): tuple(v) for k, v in m["locator"].items()}
        self.steps = {int(k): v for k, v in m["steps"].items()}
        self._leaf_ids = m["leaf_ids"]
        self.seg_live = m["seg_live"]
        # resume the segment sequence past every name ever recorded
        for names in (self.seg_live, {s for s, _l, _p in
                                      self.locator.values()}):
            for seg in names:
                try:
                    self._seg_seq = max(self._seg_seq,
                                        int(seg.rsplit("_", 1)[-1]) + 1)
                except ValueError:
                    pass
        # rebuild the LSM index from the manifest (WAL-equivalent)
        for seq in sorted(self.locator):
            _seg, leaf, page = self.locator[seq]
            self._index_put(self._page_id(leaf, page))

    # ------------------------------------------------------------ plumbing
    def _page_id(self, leaf_name: str, page_no: int) -> int:
        lid = self._leaf_ids.setdefault(leaf_name, len(self._leaf_ids))
        return (lid << 32) | page_no

    def _index_put(self, page_id: int) -> int:
        tree = self.index
        if tree.memtable.room < 1:
            tree.seal_memtable()
            tree.flush_immutable()
            tree.background_triggers()
            tree.drain_jobs()
        seq = tree.put_batch(np.asarray([page_id], np.int64))[0]
        return int(seq)

    def _pages(self, arr: np.ndarray):
        raw = arr.tobytes()
        for i in range(0, max(len(raw), 1), self.page_bytes):
            yield i // self.page_bytes, raw[i:i + self.page_bytes]

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree) -> dict:
        """Synchronous incremental save.  Returns stats."""
        names, leaves = _leaf_names(tree)
        return self._save_host(step, names, [_host(x) for x in leaves])

    def async_save(self, step: int, tree) -> threading.Thread:
        """Device->host copy happens now; serialization off-thread."""
        names, leaves = _leaf_names(tree)
        host = [_host(x) for x in leaves]
        t = threading.Thread(target=self._save_host, args=(step, names, host))
        t.start()
        self._pending.append(t)
        return t

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _save_host(self, step: int, names, host_leaves) -> dict:
        with self._lock:
            seg_name = f"seg_{step:08d}_{self._seg_seq:06d}"
            self._seg_seq += 1
            seg_path = self.root / "segments" / f"{seg_name}.npz"
            payload: dict[str, np.ndarray] = {}
            written = total = 0
            meta = {}
            for name, (arr, dtype) in zip(names, host_leaves):
                meta[name] = {"shape": list(arr.shape), "dtype": dtype}
                for page_no, blob in self._pages(arr):
                    total += 1
                    pid = self._page_id(name, page_no)
                    digest = hashlib.blake2b(blob, digest_size=16).digest()
                    if self.page_hash.get(pid) == digest:
                        continue
                    self.page_hash[pid] = digest
                    seq = self._index_put(pid)
                    self.locator[seq] = (seg_name, name, page_no)
                    payload[f"{seq}"] = np.frombuffer(blob, np.uint8)
                    written += 1
            if payload:
                np.savez(seg_path, **payload)
                self.seg_live[seg_name] = len(payload)
            self.steps[step] = {"meta": meta,
                                "max_seq": int(self.index.seq) - 1}
            self._gc()
            self._save_manifest()
            return {"pages_written": written, "pages_total": total,
                    "segment": seg_name if payload else None}

    # -------------------------------------------------------------- restore
    def restore(self, step: int | None = None, *, treedef_like=None,
                compute_device: str | torch.device | None = None,
                mesh=None, specs=None):
        """Rebuild the state at ``step`` (default: latest) as tensors.
        ``treedef_like`` is any nested dict of the saved structure (its
        leaves are not read); without it the result is a flat dict of leaf
        names.  ``compute_device`` moves every leaf there.

        With a ``DeviceMesh`` ``mesh`` and ``specs``, a tree of
        ``sharding.P`` of the saved structure that the mesh divides (as
        ``launch.specs`` or ``sharding.sanitize_spec`` give them), each
        leaf is a DTensor on the mesh: this rank reads only the pages of
        its own slice (``sharding.local_slice`` at its coordinate) into a
        host buffer of the slice's size, and the shard goes to
        ``compute_device`` (default: the mesh's device type).  No
        collective runs; the stats then also count the pages this rank
        read."""
        if (mesh is None) != (specs is None):
            raise ValueError("restore under a mesh takes both mesh and specs")
        with self._lock:
            assert self.steps, "empty store"
            step = max(self.steps) if step is None else step
            info = self.steps[step]
            max_seq = info["max_seq"]
            # newest version of each page at `step` (ascending overwrite)
            want: dict[int, int] = {}
            for seq in sorted(self.locator):
                if seq > max_seq:
                    break
                _seg, name, page = self.locator[seq]
                want[self._page_id(name, page)] = seq
            names = list(info["meta"])
            if mesh is not None:
                spec_names, spec_leaves = _leaf_names(specs)
                if spec_names != names:
                    raise ValueError(f"step {step} holds leaves {names}, the "
                                     f"specs name {spec_names}")
                sizes = axis_sizes(mesh)
                coord = dict(zip(sizes, mesh.get_coordinate()))
                device = compute_device or mesh.device_type
            segments_touched = set()
            segs: dict[str, np.lib.npyio.NpzFile] = {}
            out_leaves = []
            pages_read = 0

            def page(name: str, page_no: int) -> memoryview:
                nonlocal pages_read
                seq = want.get(self._page_id(name, page_no))
                assert seq is not None, f"missing page {name}:{page_no}"
                seg, _n, _p = self.locator[seq]
                segments_touched.add(seg)
                if seg not in segs:
                    segs[seg] = np.load(self.root / "segments" / f"{seg}.npz")
                pages_read += 1
                return memoryview(segs[seg][str(seq)])

            pb = self.page_bytes
            try:
                for i, name in enumerate(names):
                    m = info["meta"][name]
                    shape = tuple(m["shape"])
                    isz = _itemsize(m["dtype"])
                    if mesh is None:
                        buf = bytearray(math.prod(shape) * isz)
                        for page_no in range(max(1, -(-len(buf) // pb))):
                            blob = page(name, page_no)
                            off = page_no * pb
                            buf[off:off + len(blob)] = blob
                        t = _tensor(buf, m["dtype"], m["shape"])
                        out_leaves.append(t if compute_device is None
                                          else t.to(compute_device))
                        continue
                    box = local_slice(sizes, coord, spec_leaves[i], shape)
                    runs, run = _slice_runs(box, shape, isz)
                    # the shard's bytes, run by run; runs ascend, so each
                    # page is read once
                    buf = bytearray(len(runs) * run)
                    dst, held, blob = 0, -1, None
                    for start in runs:
                        pos, end = start, start + run
                        while pos < end:
                            if pos // pb != held:
                                held = pos // pb
                                blob = page(name, held)
                            off = pos - held * pb
                            n = min(end - pos, len(blob) - off)
                            buf[dst:dst + n] = blob[off:off + n]
                            pos, dst = pos + n, dst + n
                    shard = _tensor(buf, m["dtype"], [b - a for a, b in box])
                    out_leaves.append(DTensor.from_local(
                        shard.to(device), mesh,
                        placements(mesh, spec_leaves[i]), run_check=False,
                        shape=torch.Size(shape),
                        stride=tuple(math.prod(shape[j + 1:])
                                     for j in range(len(shape)))))
            finally:
                for f in segs.values():
                    f.close()
            stats = {"segments_touched": len(segments_touched),
                     "segments_total": len(self.seg_live)}
            if mesh is not None:
                stats["pages_read"] = pages_read
            if treedef_like is not None:
                like, _ = _leaf_names(treedef_like)
                if like != names:
                    raise ValueError(f"step {step} holds leaves {names}, "
                                     f"not {like}")
                return unflatten_like(treedef_like, out_leaves), stats
            return dict(zip(names, out_leaves)), stats

    # ------------------------------------------------------------------ gc
    def _gc(self):
        """Drop segments whose every page version has been superseded."""
        live_seqs = set(self.index.merged_view().values())
        counts: dict[str, int] = {}
        for seq, (seg, _n, _p) in self.locator.items():
            if seq in live_seqs:
                counts[seg] = counts.get(seg, 0) + 1
        # keep segments needed by ANY recorded step (we only GC below the
        # oldest retained step's max_seq)
        min_keep = min((s["max_seq"] for s in self.steps.values()), default=0)
        dead = []
        for seg in list(self.seg_live):
            if counts.get(seg, 0) == 0:
                seqs = [q for q, (g, _n, _p) in self.locator.items()
                        if g == seg]
                if seqs and max(seqs) <= min_keep:
                    continue  # old step may still reference -> conservative
                if not seqs:
                    dead.append(seg)
        for seg in dead:
            (self.root / "segments" / f"{seg}.npz").unlink(missing_ok=True)
            self.seg_live.pop(seg, None)

    def retain(self, last_n: int = 2):
        """Forget all but the newest n steps (enables GC of old segments)."""
        with self._lock:
            keep = sorted(self.steps)[-last_n:]
            self.steps = {k: v for k, v in self.steps.items() if k in keep}

    def index_stats(self) -> dict:
        return self.index.stats.summary()
