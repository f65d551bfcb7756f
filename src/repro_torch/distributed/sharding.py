"""Sharding rules: parameter / optimizer / input / cache specs per arch —
the port of ``repro/distributed/sharding.py``, rule for rule.

Mesh contract (``launch/mesh.py``): ``("data", "model")`` single-pod or
``("pod", "data", "model")`` multi-pod.  Batch shards over ``("pod",
"data")`` (pure data parallelism across pods, keeping the slow inter-pod
links off the tensor-parallel critical path); tensor parallelism lives on
the 16-wide intra-pod "model" axis (Megatron column->row pairs, expert
parallelism for MoE experts, vocab-parallel embeddings).  SSM mixer
weights are replicated.

A spec is :class:`P`, a tuple with one entry per tensor dimension: None
(replicated), an axis name, or a tuple of names that split the dimension
in the tuple's order, major first.  The rules take the port's parameter
trees, whose key paths are the reference's (``models.blocks.model_specs``),
and any object with a name -> size ``shape`` dict stands for a mesh
(:func:`axis_sizes`), as the reference's tests pass a ``FakeMesh``.  The
reference's two environment switches are keyword arguments here:
``attn_replicated`` (``REPRO_ATTN_REPLICATED=1``) and ``seq_shard``
(``REPRO_SEQ_SHARD=1``).

:func:`to_shardings` turns specs into DTensor placements on a
``DeviceMesh``, :func:`sanitize_spec` drops the shardings a mesh does not
divide, and :func:`local_slice` gives the index ranges a mesh coordinate
holds, without a process group.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard

from ..training.tree import leaf_paths, unflatten_like


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    A one-name tuple is that name, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order: a ``DeviceMesh``'s dimensions, or
    the ``shape`` dict of any stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _spec_for_param(cfg, path: tuple, ndim: int, *,
                    attn_replicated: bool = False) -> P:
    name = path[-1]

    def pad(spec_dims: tuple) -> P:
        return P(*([None] * (ndim - len(spec_dims)) + list(spec_dims)))
    replicated = P(*([None] * ndim))
    # embeddings / head
    if name == "embed":
        return pad(("model", None))
    if name == "lm_head":
        return pad((None, "model"))
    # SSD mixer: replicated
    if "ssd" in path:
        return replicated
    # attention (replicated in the attn_replicated variant)
    if attn_replicated and name in ("wq", "wk", "wv", "wo"):
        return replicated
    if name in ("wq", "wk", "wv", "w_uk", "w_uv"):
        return pad((None, "model"))
    if name == "wo":
        return pad(("model", None))
    if name in ("w_dkv", "w_kr"):
        return replicated
    # MLP
    if name in ("w_gate", "w_up", "s_gate", "s_up"):
        return pad((None, "model"))
    if name in ("w_down", "s_down"):
        return pad(("model", None))
    if name == "b_up":
        return pad(("model",))
    if name == "b_down":
        return replicated
    # MoE: expert-parallel over the model axis
    if name in ("e_gate", "e_up", "e_down"):
        return pad(("model", None, None))
    # the router, norms, biases, scalars: replicated
    return replicated


def _map(tree, fn):
    flat = leaf_paths(tree)
    return unflatten_like(tree, [fn(path, leaf) for path, leaf in flat])


def param_specs(cfg, params_shape, *, attn_replicated: bool = False) -> dict:
    """A :class:`P` tree matching a parameter tree (any leaves with a
    ``shape``)."""
    return _map(params_shape, lambda path, leaf: _spec_for_param(
        cfg, path, len(leaf.shape), attn_replicated=attn_replicated))


def zero1_specs(cfg, params_shape, mesh, *,
                attn_replicated: bool = False) -> dict:
    """Optimizer-moment specs: the parameter's spec with ZeRO-1's 'data'
    sharding folded onto its largest still-unsharded dimension that 'data'
    divides."""
    data = axis_sizes(mesh).get("data", 1)

    def fn(path, leaf):
        spec = list(_spec_for_param(cfg, path, len(leaf.shape),
                                    attn_replicated=attn_replicated))
        best, best_dim = None, 0
        for i, (s, d) in enumerate(zip(spec, leaf.shape)):
            if s is None and d % data == 0 and d > best_dim:
                best, best_dim = i, d
        if best is not None and best_dim >= data:
            spec[best] = "data"
        return P(*spec)
    return _map(params_shape, fn)


def train_batch_specs(cfg, mesh, *, seq_shard: bool = False) -> dict:
    """``seq_shard``: sequence/context parallelism, the sequence dimension
    over 'model'."""
    ba = batch_axes(mesh)
    seq = "model" if seq_shard else None
    specs = {"tokens": P(ba, seq), "labels": P(ba, seq)}
    if cfg.family == "encdec":
        specs["encoder_embeds"] = P(ba, None, None)
    if cfg.mrope_sections:
        specs["positions"] = P(ba, seq, None)
    return specs


def cache_specs(cfg, mesh, *, batch1: bool = False) -> dict:
    """Decode-cache specs.  Normal decode: the batch shards over the batch
    axes; KV heads shard over 'model' when it divides them, otherwise the
    sequence dimension does (``distributed/flash_decode.py`` is the decode
    over such a cache).  ``batch1`` (long_500k): the batch dimension cannot
    shard, so the sequence takes the data axes (and 'model' when the heads
    cannot use it)."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    da = ("pod", "data") if "pod" in sizes else ("data",)
    ba = None if batch1 else batch_axes(mesh)
    heads_ok = (cfg.n_kv_heads or 1) % model == 0
    if batch1:
        seq = da + (() if heads_ok else ("model",))
    else:
        seq = None if heads_ok else "model"
    hd = "model" if heads_ok else None
    sh = "model" if cfg.ssm_state and cfg.ssm_heads % model == 0 else None
    if cfg.family in ("ssm", "hybrid"):
        specs = {"conv": P(None, ba, None, None),
                 "state": P(None, ba, sh, None, None),
                 "pos": P(None)}
        if cfg.attn_every:
            specs["attn_k"] = P(None, ba, seq, hd, None)
            specs["attn_v"] = P(None, ba, seq, hd, None)
        return specs
    if cfg.family == "encdec":
        return {"k": P(None, ba, seq, hd, None),
                "v": P(None, ba, seq, hd, None),
                "cross_k": P(None, ba, None, hd, None),
                "cross_v": P(None, ba, None, hd, None),
                "pos": P(None)}
    if cfg.attn_kind == "mla":
        mseq = (da + ("model",)) if batch1 else "model"
        specs = {"ckv": P(None, ba, mseq, None),
                 "kr": P(None, ba, mseq, None),
                 "pos": P(None)}
        if cfg.first_dense_layers:
            specs["d_ckv"] = P(None, ba, mseq, None)
            specs["d_kr"] = P(None, ba, mseq, None)
        return specs
    return {"k": P(None, ba, seq, hd, None),
            "v": P(None, ba, seq, hd, None),
            "pos": P(None)}


def decode_input_specs(cfg, mesh) -> dict:
    ba = batch_axes(mesh)
    return {"tokens": P(ba, None), "pos": P(ba)}


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(i)`` where tensor dimension i names that axis, else
    ``Replicate()``.  DTensor splits a dimension sharded over several mesh
    dimensions in mesh order, major first; the spec's tuple must name them
    in that order (every rule above does), or this raises."""
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes {axes} of dimension {i} are not "
                             f"in the mesh's order {tuple(names)}")
        for j in order:
            out[j] = Shard(i)
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """The placements (:func:`placements`) of every spec of a tree."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}


def _axis_size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def sanitize_spec(mesh, spec: P, shape: tuple[int, ...]) -> P:
    """Drop shardings on dimensions the mesh axes do not divide (e.g.
    whisper's 51,865-token vocab over a 16-wide model axis): those
    dimensions replicate.  A tuple of axes keeps its longest prefix that
    divides."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape) or entry is None:
            out.append(None)
        elif shape[i] % _axis_size(sizes, entry) == 0:
            out.append(entry)
        elif isinstance(entry, tuple):
            out.append(next((entry[:j] for j in range(len(entry) - 1, 0, -1)
                             if shape[i] % _axis_size(sizes, entry[:j]) == 0),
                            None))
        else:
            out.append(None)
    return P(*out)


def local_slice(mesh_sizes: dict[str, int], coord: dict[str, int], spec: P,
                shape: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """The [start, stop) of every dimension of ``shape`` that the mesh
    coordinate ``coord`` (axis name -> index) holds under ``spec``: a
    dimension over axes (a, b) is cut into size(a) * size(b) equal blocks
    and the coordinate holds block coord[a] * size(b) + coord[b].  Raises
    where the axes do not divide the dimension (:func:`sanitize_spec`
    drops such shardings first)."""
    out = []
    for i, n in enumerate(shape):
        axes = _axes(spec[i]) if i < len(spec) else ()
        parts = math.prod(mesh_sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"axes {axes} ({parts} parts) do not divide "
                             f"dimension {i} of {tuple(shape)}")
        block = 0
        for a in axes:
            block = block * mesh_sizes[a] + coord[a]
        step = n // parts
        out.append((block * step, (block + 1) * step))
    return tuple(out)
