"""Model configurations: the port's own copy of the reference's ten
architecture configs (``repro/configs``), JAX-free as they are there."""

from .base import SHAPES, ModelConfig, ShapeSpec
from .registry import ARCH_IDS, all_configs, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeSpec", "all_configs",
           "get_config"]
