"""Hand-written Hopper kernels of the port's main paths, with their plain
PyTorch versions and launch counters.

    merge_path          — compaction's stable two-run merge
                          (csrc/merge_path.cu)
    overlap_scan        — sorted-array rank behind every fence probe
                          (csrc/overlap_scan.cu)
    lookup_probe        — the GET path's fused probe: a GET batch's walk
                          through the tree's runs in one launch (the
                          second entry of csrc/overlap_scan.cu)
    lindley_scan        — the DES's batched FIFO departure scan
                          (csrc/lindley_scan.cu)
    flash_attention     — causal / sliding-window attention of the LM
                          prefill and of every training forward; whisper's
                          bidirectional encoder and its cross attention
                          (non-causal, Sk = 1,500 encoder frames)
                          (csrc/flash_attention.cu)
    flash_attention_bwd — flash_attention's gradient in every training
                          step (csrc/flash_attention_bwd.cu)
    ssd_scan            — the Mamba2 SSD chunked scan of the LM prefill
                          and of every ssm/hybrid training forward
                          (csrc/ssd_scan.cu)
    ssd_scan_bwd        — ssd_scan's gradient in every ssm/hybrid training
                          step (csrc/ssd_scan_bwd.cu)
    paged_attention     — single-token attention of every LM decode step,
                          through a page table; whisper's self attention
                          and its cross attention over the 1,500 encoder
                          frames (csrc/paged_attention.cu)

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; its ``launches`` attribute counts kernel launches
only.  Importing this package builds nothing (see ``_build``).
"""

from .flash_attention.ops import flash_attention, flash_attention_bwd
from .lindley_scan.ops import lindley_batch
from .merge_path.ops import merge_two_runs
from .overlap_scan.ops import fence_rank, lookup_probe
from .paged_attention.ops import paged_attention
from .ssd_scan.ops import ssd_scan, ssd_scan_bwd

#: kernel name -> wrapper that counts its launches
WRAPPERS = {"merge_path": merge_two_runs, "overlap_scan": fence_rank,
            "lookup_probe": lookup_probe,
            "lindley_scan": lindley_batch, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
            "paged_attention": paged_attention}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "fence_rank", "flash_attention", "flash_attention_bwd",
           "launch_counts", "lindley_batch", "lookup_probe",
           "merge_two_runs",
           "paged_attention", "reset_launch_counts", "ssd_scan",
           "ssd_scan_bwd"]
