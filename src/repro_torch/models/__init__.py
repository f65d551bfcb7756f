"""The language-model stack of the port (decoder, ssm, hybrid and encdec
families): the counterpart of ``repro/models``."""

from .blocks import encode, forward, init_model, model_specs, train_loss
from .decode import cache_shapes, decode_step, init_cache
from .state import params_from_jax

__all__ = ["cache_shapes", "decode_step", "encode", "forward", "init_cache",
           "init_model", "model_specs", "params_from_jax", "train_loss"]
