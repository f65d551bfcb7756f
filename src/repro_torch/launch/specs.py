"""Shape-and-spec stand-ins for every model input — the port of
``repro/launch/specs.py``, without allocating anything.

Each function returns trees of :class:`Leaf` ``(shape, dtype, spec)``, the
port's counterpart of a ``ShapeDtypeStruct`` with its ``NamedSharding``,
for the step a cell runs:

  train   -> (params, opt_state, batch)
  prefill -> (params, batch)
  decode  -> (params, tokens, pos, cache)

Parameter shapes come from ``models.model_specs`` and cache shapes from
``models.decode.cache_shapes``, so nothing is allocated, not even on the
meta device: yi-6b's decode_32k cache alone would be ~275 GB.  Every
parameter, optimizer, batch and cache spec is sanitized against the mesh
(:func:`sanitize_spec`), the decode tokens' and positions' are not, as in
the reference.  Modality frontends are the reference's stubs: whisper gets
precomputed frame embeddings, qwen2-vl M-RoPE positions.  whisper's cross
cache has the port's 1,504 rows (``models.blocks.cross_rows``) where the
reference's has 1,500; its spec replicates that dimension either way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..distributed.sharding import (P, axis_sizes, batch_axes, cache_specs,
                                    decode_input_specs, param_specs,
                                    sanitize_spec, train_batch_specs,
                                    zero1_specs)
from ..models.blocks import model_specs
from ..models.common import DTYPES
from ..models.decode import cache_shapes
from ..training.tree import tree_map

FSDP_THRESHOLD_BYTES = 4 << 30   # shard params over 'data' too beyond this


@dataclass(frozen=True)
class Leaf:
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: P | None = None


def _sharded(tree, spec_tree, mesh):
    return tree_map(lambda leaf, spec: Leaf(
        leaf.shape, leaf.dtype, sanitize_spec(mesh, spec, leaf.shape)),
        tree, spec_tree)


def params_shape(cfg) -> dict:
    """The parameter tree as :class:`Leaf` s without specs."""
    return tree_map(lambda s: Leaf(tuple(s[1]), DTYPES[s[2]]),
                     model_specs(cfg))


def needs_fsdp(cfg, mesh) -> bool:
    model = axis_sizes(mesh).get("model", 1)
    return cfg.param_count() * 2 / model > FSDP_THRESHOLD_BYTES


def make_param_specs(cfg, mesh, *, fsdp: bool | None = None):
    pshape = params_shape(cfg)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, mesh)
    if fsdp:
        return pshape, zero1_specs(cfg, pshape, mesh)   # fold 'data' in too
    return pshape, param_specs(cfg, pshape)


def _batch_shapes(cfg, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": Leaf((b, s), torch.int32),
             "labels": Leaf((b, s), torch.int32)}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = Leaf((b, cfg.enc_seq, cfg.d_model),
                                       DTYPES[cfg.param_dtype])
    if cfg.mrope_sections:
        batch["positions"] = Leaf((b, s, 3), torch.int32)
    return batch


def train_specs(cfg, shape, mesh, *, fsdp: bool | None = None):
    pshape, pspec = make_param_specs(cfg, mesh, fsdp=fsdp)
    params = _sharded(pshape, pspec, mesh)
    zspec = zero1_specs(cfg, pshape, mesh)
    moments = tree_map(lambda leaf: Leaf(leaf.shape, torch.float32), pshape)
    opt = {"m": _sharded(moments, zspec, mesh),
           "v": _sharded(moments, zspec, mesh),
           "step": Leaf((), torch.int32, P())}
    batch = _batch_shapes(cfg, shape)
    bspec = {k: v for k, v in train_batch_specs(cfg, mesh).items()
             if k in batch}
    return params, opt, _sharded(batch, bspec, mesh)


def prefill_specs(cfg, shape, mesh, *, fsdp: bool | None = None):
    pshape, pspec = make_param_specs(cfg, mesh, fsdp=fsdp)
    batch = _batch_shapes(cfg, shape)
    batch.pop("labels")
    bspec = {k: v for k, v in train_batch_specs(cfg, mesh).items()
             if k in batch}
    return _sharded(pshape, pspec, mesh), _sharded(batch, bspec, mesh)


def decode_specs(cfg, shape, mesh, *, fsdp: bool | None = None):
    pshape, pspec = make_param_specs(cfg, mesh, fsdp=fsdp)
    b, s = shape.global_batch, shape.seq_len
    cshape = {k: Leaf(tuple(sh), dt)
              for k, (sh, dt) in cache_shapes(cfg, b, s).items()}
    sizes = axis_sizes(mesh)
    batch1 = b < math.prod(sizes[a] for a in batch_axes(mesh))
    if batch1:
        tok_spec = {"tokens": P(None, None), "pos": P(None)}
    else:
        tok_spec = decode_input_specs(cfg, mesh)
    tokens = Leaf((b, 1), torch.int32, tok_spec["tokens"])
    pos = Leaf((b,), torch.int32, tok_spec["pos"])
    return (_sharded(pshape, pspec, mesh), tokens, pos,
            _sharded(cshape, cache_specs(cfg, mesh, batch1=batch1), mesh))
