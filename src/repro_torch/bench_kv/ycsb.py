"""Open-loop YCSB harness (§5 of the paper, Figure 5).

Requests are generated at a fixed rate into an unbounded queue — the
coordinated-omission-free methodology — and the DES measures end-to-end
per-request latency from the time each request is sent.  ``sustainable_throughput``
mirrors the paper's profiling run: drive the store at a high rate and
report the completion rate.  ``device`` is the storage model;
``compute_device`` the torch device the store runs on (default ``"cuda"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import DeviceModel, LSMConfig, SimResult, Simulator
from ..core.stats import (CYC_MANIFEST_FLUSH, CYC_MERGE_KEY, CYC_OP_BASE,
                          CYC_OVERLAP_PROBE, CYC_SST_CREATE)
from .workloads import WorkloadSpec

PAPER_SCALE = 64 << 20   # the byte size that "64 MB" maps to at scale 1.0


@dataclass
class YCSBResult:
    name: str
    sim: SimResult
    rate: float
    scale_lam: float
    extra: dict = field(default_factory=dict)

    def cycles_per_op(self) -> float:
        """Scale-invariant CPU proxy: per-file overheads are charged at the
        λ-scaled rate so file counts per op match the paper's at the same
        *relative* SST size."""
        st = self.sim.stats
        lam = self.scale_lam
        cyc = (CYC_MERGE_KEY * st.merged_keys
               + CYC_OVERLAP_PROBE * st.overlap_probes
               + CYC_SST_CREATE * lam * st.ssts_created
               + CYC_MANIFEST_FLUSH * lam * st.manifest_flushes
               + CYC_OP_BASE * st.ops)
        return cyc / max(1, st.ops)

    def row(self) -> dict:
        d = {"workload": self.name, "rate_ops_s": int(self.rate)}
        d.update(self.sim.summary())
        d["cycles_per_op_scaled"] = round(self.cycles_per_op(), 0)
        d.update(self.extra)
        return d


def run_ycsb(cfg: LSMConfig, spec: WorkloadSpec, rate: float,
             n_regions: int = 1, scale: int | None = None,
             device: DeviceModel | None = None,
             preload: np.ndarray | None = None,
             compute_device: str | torch.device = "cuda") -> YCSBResult:
    """Run one workload at a fixed request rate against a fresh store.

    ``preload`` keys are ingested first (back-to-back at the same rate) so
    mixed Run-X workloads hit a populated store, as YCSB does.
    """
    scale = scale if scale is not None else cfg.memtable_size
    lam = scale / PAPER_SCALE
    device = device or DeviceModel.scaled(lam)
    sim = Simulator(cfg, device, n_regions=n_regions,
                    compute_device=compute_device)

    op_types, keys = spec.op_types, spec.keys
    scan_lens = spec.scan_lens
    n_pre = 0
    if preload is not None and preload.size:
        n_pre = preload.shape[0]
        op_types = np.concatenate([np.zeros(n_pre, np.uint8), op_types])
        keys = np.concatenate([preload, keys])
        if scan_lens is not None:
            scan_lens = np.concatenate([np.zeros(n_pre, np.int32), scan_lens])
    arrivals = np.arange(op_types.shape[0], dtype=np.float64) / rate
    res = sim.run(op_types, keys, arrivals, scan_lens=scan_lens)
    if n_pre:
        # report latency/percentiles on the measured phase only
        res = SimResult(
            arrivals=res.arrivals[n_pre:], latency=res.latency[n_pre:],
            op_types=res.op_types[n_pre:], stall_total=res.stall_total,
            stall_max=res.stall_max, n_stalls=res.n_stalls, stats=res.stats,
            job_log=res.job_log, makespan=res.makespan,
            get_reads=res.get_reads[n_pre:], get_probed=res.get_probed[n_pre:],
        )
    out = YCSBResult(spec.name, res, rate, lam)
    out.extra["levels_mb"] = [round(s / 1e6, 2) for s in sim.trees[0].level_sizes()]
    out.extra["_sim"] = sim
    return out


def sustainable_throughput(cfg: LSMConfig, spec: WorkloadSpec,
                           n_regions: int = 1, scale: int | None = None,
                           probe_rate: float = 1.5e6,
                           compute_device: str | torch.device = "cuda"
                           ) -> float:
    """Paper §5: profile at a very high generator rate; the completion rate
    is the system's sustainable throughput."""
    res = run_ycsb(cfg, spec, probe_rate, n_regions, scale,
                   compute_device=compute_device)
    return res.sim.throughput
