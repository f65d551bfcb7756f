"""Incremental LSM checkpointing of the port over its own vLSM store:
the counterpart of ``repro/checkpoint``."""

from .lsm_checkpoint import PAGE_BYTES, LSMCheckpointStore

__all__ = ["LSMCheckpointStore", "PAGE_BYTES"]
