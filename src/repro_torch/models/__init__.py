"""The language-model stack of the port (decoder, ssm and hybrid
families): the counterpart of ``repro/models``."""

from .blocks import forward, init_model, model_specs
from .decode import decode_step, init_cache
from .state import params_from_jax

__all__ = ["decode_step", "forward", "init_cache", "init_model",
           "model_specs", "params_from_jax"]
