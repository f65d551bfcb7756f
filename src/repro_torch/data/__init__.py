"""Token pipeline of the port (numpy only): the counterpart of
``repro/data``."""

from .pipeline import BatchAllocator, PipelineState, TokenPipeline

__all__ = ["BatchAllocator", "PipelineState", "TokenPipeline"]
