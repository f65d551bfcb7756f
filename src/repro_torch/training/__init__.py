"""Training of the port: AdamW and the train/serve step factories — the
counterpart of ``repro/training``."""

from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .step import make_prefill, make_serve_step, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "make_prefill",
           "make_serve_step", "make_train_step"]
