"""The distribution layer of the port, on ``torch.distributed``: the
sharding rules (``sharding``), int8 gradient compression
(``compression``), sequence-sharded decode attention (``flash_decode``),
GPipe stages (``pipeline``), and the collectives over a ``DeviceMesh``
axis that they share (``comm``) — the counterpart of
``repro/distributed``."""

from .sharding import (batch_axes, cache_specs, decode_input_specs,
                       param_specs, to_shardings, train_batch_specs,
                       zero1_specs)

__all__ = ["batch_axes", "cache_specs", "decode_input_specs", "param_specs",
           "to_shardings", "train_batch_specs", "zero1_specs"]
