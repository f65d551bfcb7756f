"""Hand-written Hopper kernels of the store's main path, with their plain
PyTorch versions and launch counters.

    merge_path    — compaction's stable two-run merge  (csrc/merge_path.cu)
    overlap_scan  — sorted-array rank behind every fence/GET probe
                    (csrc/overlap_scan.cu)
    lindley_scan  — the DES's batched FIFO departure scan
                    (csrc/lindley_scan.cu)

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; its ``launches`` attribute counts kernel launches
only.  Importing this package builds nothing (see ``_build``).
"""

from .lindley_scan.ops import lindley_batch
from .merge_path.ops import merge_two_runs
from .overlap_scan.ops import fence_rank

#: kernel name -> wrapper that counts its launches
WRAPPERS = {"merge_path": merge_two_runs, "overlap_scan": fence_rank,
            "lindley_scan": lindley_batch}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "fence_rank", "launch_counts", "lindley_batch",
           "merge_two_runs", "reset_launch_counts"]
