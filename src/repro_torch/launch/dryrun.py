"""Multi-pod dry-run without a compiler: every (arch × shape × mesh) cell
planned on one CPU process, nothing allocated — the port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell through XLA on 512 placeholder
devices and reads its memory, cost and collectives from the compiled
program.  The port has no compiler to ask, so each number has a method of
its own, and every cell gives the reference's result dict (``lower_s`` and
``compile_s`` become ``trace_s``), priced against an H100 SXM: 989 TFLOP/s
bf16 dense, 3.35 TB/s of HBM, 450 GB/s each way over NVLink.

* **Mesh.** Planning takes the mesh's axis sizes (``{"data": 16, "model":
  16}``, ``{"pod": 2, "data": 16, "model": 16}``): a caller with a real
  process group passes ``sharding.axis_sizes`` of its ``DeviceMesh``.  The
  CLI builds the production meshes of ``launch/mesh.py`` on torch's
  ``fake`` process-group backend (512 ranks in one process) and reads
  their sizes.
* **Argument bytes per device** (``memory.argument_bytes``): exact, from
  ``launch/specs.py``'s :class:`~repro_torch.launch.specs.Leaf` trees, each
  leaf's shard the extent ``sharding.local_slice`` gives (the largest
  rank's where a dimension does not divide: the decode tokens' and
  positions' specs are not sanitized).
* **FLOPs and bytes accessed.** The cell's step — a training step with
  remat and AdamW (``training.step.make_train_step``), the prefill
  (``models.forward``) or one decode step (``models.decode_step``) — runs
  under ``FakeTensorMode`` at the global shapes with
  ``compute_device="cpu"``, so the kernels' plain versions are what is
  counted.  FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s
  (matrix products and attention; elementwise work is not counted); bytes
  are each aten op's distinct input and output tensors, views excluded, an
  unfused upper bound on HBM traffic.  Both are divided by ``chips``.  The
  plain attention computes every S × S score, masked or not, and its
  S × S temporaries, where the kernels skip masked blocks and keep none,
  so ``useful_flops_ratio`` (the reference's 6·N·tokens, 2·N·tokens for a
  prefill, 2·N a decoded token, over the counted FLOPs) sits below the
  kernels' own.  The MoE's load-balance ``torch.bincount`` has a
  data-dependent shape a fake tensor refuses; it is routed statically to
  its ``minlength`` (every expert id is below it, so that is its size)
  and its bytes counted by hand.
* **Temporaries** (``memory.temp_bytes``): the peak of the fake tensors'
  live storage bytes during the step beyond its arguments, divided by
  ``chips`` — an estimate that assumes even sharding.  The plain versions
  build temporaries the kernels never do (flash attention's S × S scores,
  the ssd scan's per-step states), so it is an upper bound.
* **Collective bytes.** The sharding rules' own accounting, per device,
  with the reference's ring factors (``2·b·(g−1)/g`` an all-reduce,
  ``b·(g−1)/g`` an all-gather of result ``b``, ``b·(g−1)`` a
  reduce-scatter of result ``b``):

  - per parameter leaf (training): an FSDP leaf (its spec names a batch
    axis) is all-gathered over those axes twice, for the forward and for
    the backward (remat's recomputation and the gradient's products share
    the second), and its gradient reduce-scattered over them; ZeRO-1's
    axes (the moments' spec's batch axes the parameter's lacks) take the
    gradient's reduce-scatter and, after the update, the parameter's
    all-gather; the batch axes left over all-reduce the gradient's shard.
    A prefill or decode step all-gathers each FSDP leaf once.
  - per block: a product whose contracted dimension is sharded over
    ``model`` (``wo``, ``w_down``, the vocab-parallel embedding) ends in an
    all-reduce of its [tokens, out] activation over ``model`` — once in
    the forward, again in remat's second forward of a stacked layer, and
    once in the backward for the column-parallel input's gradient (none
    for the embedding, which has no input to differentiate); a
    vocab-parallel head takes that backward all-reduce, and the training
    loss three [tokens] fp32 all-reduces (max, sum, gold logit).  An
    expert-parallel MoE layer all-gathers its experts' [E, C, D] outputs
    over ``model`` in each forward and reduce-scatters their gradient.
  - for decode, the sequence-sharded combine of every attention layer
    whose cache shards its sequence: all-reduces of the partial max and
    sum [B, H] and output [B, H, Dv] in fp32 over the sequence's axes.

  Every axis is priced at NVLink's rate, which flatters a ``pod`` axis
  that would cross nodes.
* **Composed cost.** Where the trace's op count grows with depth times
  the plain ssd scan's chunks (the ssm and hybrid families' training and
  prefill cells) and for deepseek-v2-236b's training cell, the cost is
  composed as in the reference's ``run_composed``, from the stack traced
  at ``first_dense_layers`` + 1, + 2 and + 3 layers (:func:`composed_trace`:
  a training step's bytes grow with the square of the depth, so the
  reference's two depths do not suffice); the hybrid's shared attention
  block is one more term.  FLOPs, bytes and ops come out exact; the
  temporaries are the deepest trace's peak grown by its last layer's
  kept bytes, an estimate.  ``--composed``
  composes every selected cell.

``long_500k`` is skipped for full-attention archs, as in the reference.
A cell that cannot be traced records its error.  Results are cached as
JSON per cell under ``results/dryrun_torch/``.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--force]
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, ShapeSpec, get_config
from ..configs.registry import ARCH_IDS
from ..distributed.sharding import (P, _axes, _axis_size, axis_sizes,
                                    batch_axes)
from ..models.blocks import segments
from ..training.tree import leaf_paths
from .specs import Leaf, decode_specs, needs_fsdp, prefill_specs, train_specs

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# H100 SXM constants (per card)
PEAK_FLOPS = 989e12        # bf16 dense
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s each way, NVLink

#: (arch, shape) cells composed by default (see the module docstring)
COMPOSED_CELLS = {("deepseek_v2_236b", "train_4k")}


class MeshSizes:
    """A mesh stand-in for the spec functions: its ``shape`` is the axis
    name -> size dict (``sharding.axis_sizes`` reads it)."""

    def __init__(self, sizes: dict[str, int]):
        self.shape = dict(sizes)


def mesh_name(sizes: dict[str, int]) -> str:
    return "x".join(str(v) for v in sizes.values())


def production_sizes(multi_pod: bool) -> dict[str, int]:
    """Axis sizes of ``launch.mesh.make_production_mesh`` built on torch's
    ``fake`` process-group backend (one process stands for 256 or 512
    ranks)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_production_mesh
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        return axis_sizes(make_production_mesh(multi_pod,
                                               device_type="cpu"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- argument bytes
def shard_shape(sizes: dict[str, int], leaf: Leaf) -> tuple[int, ...]:
    """The largest rank's extent of every dimension of ``leaf`` under its
    spec (``sharding.local_slice``'s where the axes divide it)."""
    spec = leaf.spec or P()
    return tuple(-(-n // _axis_size(sizes, spec[i] if i < len(spec)
                                    else None))
                 for i, n in enumerate(leaf.shape))


def leaf_bytes(sizes: dict[str, int], leaf: Leaf) -> int:
    return math.prod(shard_shape(sizes, leaf)) * leaf.dtype.itemsize


def arg_leaves(args: dict) -> list[Leaf]:
    """Every argument tensor of :func:`cell_args`' trees."""
    return [leaf for tree in args.values()
            for leaf in ([tree] if isinstance(tree, Leaf)
                         else [x for _, x in leaf_paths(tree)])]


def cell_args(cfg, shape: ShapeSpec, sizes: dict[str, int], *,
              fsdp: bool | None = None) -> dict:
    """name -> Leaf tree of the cell's step arguments under ``sizes``."""
    mesh = MeshSizes(sizes)
    if shape.kind == "train":
        params, opt, batch = train_specs(cfg, shape, mesh, fsdp=fsdp)
        return {"params": params, "opt": opt, "batch": batch}
    if shape.kind == "prefill":
        params, batch = prefill_specs(cfg, shape, mesh, fsdp=fsdp)
        return {"params": params, "batch": batch}
    params, tokens, pos, cache = decode_specs(cfg, shape, mesh, fsdp=fsdp)
    return {"params": params, "tokens": tokens, "pos": pos, "cache": cache}


def argument_bytes(sizes: dict[str, int], args: dict) -> tuple[int, int]:
    """(bytes a device holds of the step's arguments, their tensor count)."""
    flat = arg_leaves(args)
    return sum(leaf_bytes(sizes, leaf) for leaf in flat), len(flat)


# ---------------------------------------------------------- the fake trace
_BINCOUNT = torch.ops.aten.bincount.default


class _Meter(TorchDispatchMode):
    """Bytes accessed, op count, and live storage bytes with their peak,
    over the aten ops of a fake trace; ``bincount`` routed to its
    ``minlength``.  The storages of ``args`` (the step's arguments, which
    an in-place update hands back) are not the step's own."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.storages: dict[int, weakref.finalize] = {}
        self.args = {id(t.untyped_storage()) for t in tree_leaves(args)
                     if isinstance(t, torch.Tensor)}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.storages or key in self.args:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(key=key, n=n):
            self.live -= n
            self.storages.pop(key, None)
        self.storages[key] = weakref.finalize(st, release)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func is _BINCOUNT:
            minlength = kwargs.get("minlength",
                                   args[2] if len(args) > 2 else 0)
            out = torch.zeros(minlength, dtype=torch.int64,
                              device=args[0].device)
        else:
            out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            seen: set[int] = set()
            for t in [x for x in tree_leaves((args, kwargs))
                      if isinstance(x, torch.Tensor)] + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes_accessed += t.numel() * t.element_size()
        for t in outs:
            self._track(t)
        return out

    def owned_bytes(self, tree) -> int:
        """Bytes of the distinct storages in ``tree`` made during the
        trace (not the step's arguments)."""
        total, seen = 0, set()
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) in self.storages and id(st) not in seen:
                    seen.add(id(st))
                    total += st.nbytes()
        return total


@dataclass
class Trace:
    """Global (undivided) counts of one traced or composed step."""

    flops: float
    bytes_accessed: float
    temp_bytes: float
    output_bytes: float
    ops: int
    trace_s: float

    def __add__(self, o: "Trace") -> "Trace":
        return Trace(*(a + b for a, b in zip(self._t(), o._t())))

    def __sub__(self, o: "Trace") -> "Trace":
        return Trace(*(a - b for a, b in zip(self._t(), o._t())))

    def scaled(self, k: float) -> "Trace":
        return Trace(*(a * k for a in self._t()))

    def _t(self) -> tuple:
        return (self.flops, self.bytes_accessed, self.temp_bytes,
                self.output_bytes, self.ops, self.trace_s)


def _fake(tree):
    if isinstance(tree, Leaf):
        return torch.empty(tree.shape, dtype=tree.dtype)
    return {k: _fake(v) for k, v in tree.items()}


def trace_step(cfg, shape: ShapeSpec, *, variant: str = "baseline") -> Trace:
    """Run the cell's step once under ``FakeTensorMode`` at its global
    shapes with the kernels' plain versions, and count it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import decode_step, forward
    from ..models.attention import _identity_table
    from ..training.step import make_train_step
    t0 = time.perf_counter()
    args = cell_args(cfg, shape, {"data": 1, "model": 1}, fsdp=False)
    # decode's memo of page tables would hand a fake table to a later
    # trace (or to a real step)
    _identity_table.cache_clear()
    with FakeTensorMode():
        fake = {k: _fake(v) for k, v in args.items()}
        flops = FlopCounterMode(display=False)
        meter = _Meter(fake)
        if shape.kind == "train":
            step = make_train_step(cfg, remat=True, compute_device="cpu")
            with flops, meter:
                out = step(fake["params"], fake["opt"], fake["batch"])
        else:
            with torch.no_grad(), flops, meter:
                if shape.kind == "prefill":
                    out = forward(cfg, fake["params"], fake["batch"],
                                  mode="prefill", remat=False,
                                  compute_device="cpu")
                else:
                    out = decode_step(
                        cfg, fake["params"], fake["tokens"], fake["pos"],
                        fake["cache"],
                        absorbed_mla=(variant != "expand_mla"),
                        compute_device="cpu")
        output_bytes = meter.owned_bytes(out)
        del out, fake
    _identity_table.cache_clear()
    return Trace(flops=float(flops.get_total_flops()),
                 bytes_accessed=float(meter.bytes_accessed),
                 temp_bytes=float(meter.peak),
                 output_bytes=float(output_bytes), ops=meter.ops,
                 trace_s=time.perf_counter() - t0)


def composed_trace(cfg, shape: ShapeSpec, *,
                   variant: str = "baseline") -> Trace:
    """The reference's ``run_composed`` decomposition, with one more
    depth: the stack traced at ``first_dense_layers`` + 1, + 2 and + 3
    layers and extrapolated to L by forward differences, exact for counts
    quadratic in depth.  FLOPs and ops are linear in it; bytes are not,
    because autograd's gradient of each stacked layer's slice
    (``select_backward``) fills a zero tensor of the whole [L, ...] stack,
    so the gradient of a stacked parameter moves L x its bytes.  The
    hybrid's shared block is one more term, linear in its applications:
    one and two of them traced at two and three layers (``attn_every``
    1), each less the same stack with none applied."""
    runs: list[Trace] = []

    def at(**kw) -> Trace:
        runs.append(trace_step(cfg.with_(**kw), shape, variant=variant))
        return runs[-1]

    if cfg.attn_every:
        f1, f2, f3 = (at(n_layers=n, attn_every=4) for n in (1, 2, 3))
        # one and two applications at two and three layers, each less the
        # same stack without any: the second adds its gradients to the
        # first's
        s1 = at(n_layers=2, attn_every=1) - f2
        s2 = at(n_layers=3, attn_every=1) - f3
        apps = sum(1 for _, end in segments(cfg) if end < cfg.n_layers)
        k = cfg.n_layers - 1
    else:
        fd = cfg.first_dense_layers
        f1, f2, f3 = (at(n_layers=fd + d) for d in (1, 2, 3))
        apps, k = 0, cfg.n_layers - fd - 1
    total = f1 + (f2 - f1).scaled(k) \
        + (f3 - f2.scaled(2) + f1).scaled(k * (k - 1) // 2)
    # a peak is no sum: the deepest trace's, growing by its last layer's
    # kept bytes, and the shared block's kept bytes per application
    temp = (f1, f2, f3)[min(k, 2)].temp_bytes \
        + max(0, k - 2) * max(0.0, f3.temp_bytes - f2.temp_bytes)
    if apps:
        total = total + s1 + (s2 - s1).scaled(apps - 1)
        temp += max(0.0, s1.temp_bytes) \
            + (apps - 1) * max(0.0, s2.temp_bytes - s1.temp_bytes)
    total.temp_bytes = temp
    total.ops = int(total.ops)
    total.trace_s = sum(r.trace_s for r in runs)
    return total


# ----------------------------------------------------------- collectives
_OPS = ("all-reduce", "all-gather", "reduce-scatter")


class _Wire:
    """Per-device wire bytes by collective type, with the reference's ring
    factors."""

    def __init__(self, sizes: dict[str, int]):
        self.sizes = sizes
        self.totals = {op: 0.0 for op in _OPS}
        self.counts = {op: 0 for op in _OPS}

    def add(self, op: str, axes, nbytes: float, times: int = 1) -> None:
        g = math.prod(self.sizes[a] for a in axes)
        if g <= 1 or times <= 0 or nbytes <= 0:
            return
        if op == "all-reduce":
            wire = 2.0 * nbytes * (g - 1) / g
        elif op == "all-gather":
            wire = nbytes * (g - 1) / g
        else:
            wire = nbytes * (g - 1)
        self.totals[op] += wire * times
        self.counts[op] += times

    def report(self) -> dict:
        out = {op: w for op, w in self.totals.items() if self.counts[op]}
        out["_count"] = sum(self.counts.values())
        out["per_op_counts"] = {op: c for op, c in self.counts.items() if c}
        return out


def _spec_axes(leaf: Leaf) -> set[str]:
    return {a for e in (leaf.spec or ()) for a in _axes(e)}


def _grad_collectives(w: _Wire, sizes, bax: tuple, p: Leaf, z: Leaf) -> None:
    """One parameter leaf's gathers and gradient reductions in a training
    step (``p`` its spec, ``z`` its moments')."""
    dp = tuple(a for a in bax if a in _spec_axes(p))
    zero = tuple(a for a in bax if a in _spec_axes(z) and a not in dp)
    rest = tuple(a for a in bax if a not in dp and a not in zero)
    local = leaf_bytes(sizes, p)
    full_dp = local * math.prod(sizes[a] for a in dp)
    w.add("all-gather", dp, full_dp, times=2)
    w.add("reduce-scatter", dp, local)
    shard = local // math.prod(sizes[a] for a in zero)
    w.add("reduce-scatter", zero, shard)
    w.add("all-gather", zero, local)
    w.add("all-reduce", rest, shard)


def _moe_capacity(cfg, tokens: int) -> int:
    return max(8, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.n_experts))


def collective_plan(cfg, shape: ShapeSpec, sizes: dict[str, int],
                    args: dict, *, variant: str = "baseline") -> dict:
    """Per-device collective wire bytes of one step (module docstring)."""
    w = _Wire(sizes)
    bax = batch_axes(MeshSizes(sizes))
    train = shape.kind == "train"
    params = leaf_paths(args["params"])
    if train:
        moments = dict(leaf_paths(args["opt"]["m"]))
        for path, p in params:
            _grad_collectives(w, sizes, bax, p, moments[path])
    else:
        for _, p in params:
            dp = tuple(a for a in bax if a in _spec_axes(p))
            w.add("all-gather", dp,
                  leaf_bytes(sizes, p) * math.prod(sizes[a] for a in dp))

    # tokens a device holds
    tok = args["tokens"] if shape.kind == "decode" else \
        args["batch"]["tokens"]
    b_local = shard_shape(sizes, tok)[0]
    dec_tokens = b_local * (1 if shape.kind == "decode" else shape.seq_len)
    enc_tokens = b_local * cfg.enc_seq
    apps_shared = sum(1 for _, end in segments(cfg)
                      if cfg.attn_every and end < cfg.n_layers)
    model = ("model",)
    for path, p in params:
        spec = p.spec or P()
        if len(p.shape) < 2:
            continue
        row = "model" in _axes(spec[-2]) and "model" not in _axes(spec[-1])
        stacked = path[0] in ("layers", "encoder")
        apps = (p.shape[0] if stacked
                else apps_shared if path[0] == "shared_attn" else 1)
        tokens = enc_tokens if path[0] == "encoder" else dec_tokens
        item = p.dtype.itemsize
        if path[-1] == "embed":
            w.add("all-reduce", model, tokens * p.shape[-1] * item)
            if train and cfg.tie_embeddings:      # the head: embed.T
                w.add("all-reduce", model, tokens * p.shape[-1] * item)
            continue
        if path[-1] == "lm_head":
            if train:
                w.add("all-reduce", model, tokens * p.shape[-2] * item)
            continue
        if path[-1] == "e_down" and "model" in _axes(spec[-3]):
            e, d = p.shape[-3], p.shape[-1]
            nbytes = e * _moe_capacity(cfg, dec_tokens) * d * item
            fwd = 2 if (train and path[0] == "layers") else 1
            w.add("all-gather", model, nbytes, times=apps * fwd)
            if train:
                w.add("reduce-scatter", model, nbytes // sizes["model"],
                      times=apps)
            continue
        if not row:
            continue
        fwd = 2 if (train and path[0] == "layers") else 1
        bwd = 1 if train else 0
        w.add("all-reduce", model, tokens * p.shape[-1] * item,
              times=apps * (fwd + bwd))
    if train:
        w.add("all-reduce", model, dec_tokens * 4, times=3)
    if shape.kind == "decode":
        _combine_collectives(w, cfg, sizes, args, b_local, variant)
    return w.report()


def _combine_collectives(w: _Wire, cfg, sizes, args, b_local: int,
                         variant: str) -> None:
    """The sequence-sharded decode's combine over each attention layer
    whose cache shards its sequence."""
    cache = args["cache"]
    key = next((k for k in ("k", "ckv", "attn_k") if k in cache), None)
    if key is None:
        return
    seq = _axes(cache[key].spec[2])
    if not seq:
        return
    params = dict(leaf_paths(args["params"]))
    wq = next((p for path, p in params.items()
               if path[-1] in ("wq", "w_uk") and path[0] != "encoder"),
              None)
    hq = cfg.n_heads
    if wq is not None and "model" in _axes((wq.spec or P(None))[-1]) \
            and "model" not in seq:
        hq //= sizes["model"]
    if cfg.attn_kind == "mla":
        dv = cfg.kv_lora_rank if variant != "expand_mla" else cfg.v_head_dim
    else:
        dv = cfg.head_dim
    layers = sum(cache[k].shape[0] for k in ("k", "ckv", "d_ckv", "attn_k")
                 if k in cache)
    w.add("all-reduce", seq, b_local * hq * 4, times=2 * layers)
    w.add("all-reduce", seq, b_local * hq * dv * 4, times=layers)


# ------------------------------------------------------------- one cell
def _roofline(flops: float, nbytes: float, wire: float) -> dict:
    t_c, t_m, t_x = flops / PEAK_FLOPS, nbytes / HBM_BW, wire / LINK_BW
    return {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "dominant": max((("compute", t_c), ("memory", t_m),
                             ("collective", t_x)), key=lambda kv: kv[1])[0]}


def model_flops(cfg, shape: ShapeSpec) -> float:
    """The reference's useful FLOPs of a step: 6·N·tokens training,
    2·N·tokens a prefill, 2·N a decoded token (N active parameters)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n * shape.global_batch * shape.seq_len
    return 2 * n * shape.global_batch


def skip_reason(cfg, shape: ShapeSpec) -> str | None:
    if shape.kind == "decode" and shape.seq_len > 100_000 \
            and not cfg.sub_quadratic:
        return ("long_500k needs sub-quadratic attention "
                "(full-attention arch)")
    return None


def default_composed(cfg, shape: ShapeSpec) -> bool:
    return ((cfg.name, shape.name) in COMPOSED_CELLS
            or (cfg.family in ("ssm", "hybrid")
                and shape.kind in ("train", "prefill")))


def plan_cell(cfg, shape: ShapeSpec, sizes: dict[str, int], *,
              variant: str = "baseline", fsdp: bool | None = None,
              composed: bool | None = None,
              traces: dict | None = None) -> dict:
    """One cell's result dict under mesh axis ``sizes``.  The trace is
    global, so a caller planning one cell on several meshes passes a
    ``traces`` dict, which memoizes it per (config, shape, variant,
    composed)."""
    reason = skip_reason(cfg, shape)
    if reason:
        return {"skipped": reason}
    sizes = dict(sizes)
    chips = math.prod(sizes.values())
    mesh = MeshSizes(sizes)
    fsdp = bool(fsdp if fsdp is not None else needs_fsdp(cfg, mesh))
    args = cell_args(cfg, shape, sizes, fsdp=fsdp)
    arg_bytes, n_tensors = argument_bytes(sizes, args)
    if composed is None:
        composed = default_composed(cfg, shape)
    traces = {} if traces is None else traces
    key = (cfg, shape, variant, composed)
    if key not in traces:
        traces[key] = (composed_trace if composed else trace_step)(
            cfg, shape, variant=variant)
    tr = traces[key]
    coll = collective_plan(cfg, shape, sizes, args, variant=variant)
    wire = sum(v for k, v in coll.items()
               if k not in ("_count", "per_op_counts"))
    flops = tr.flops / chips
    nbytes = tr.bytes_accessed / chips
    temp = tr.temp_bytes / chips
    mflops = model_flops(cfg, shape)
    return {
        "arch": cfg.name, "shape": shape.name, "variant": variant,
        "mesh": mesh_name(sizes), "chips": chips, "fsdp": fsdp,
        "method": ("composed (1-3-layer traces, forward differences)"
                   if composed else "fake trace"),
        "trace_s": tr.trace_s, "trace_ops": tr.ops,
        "flops_per_device": flops, "bytes_per_device": nbytes,
        "collective_wire_bytes_per_device": wire,
        "collectives": coll,
        "memory": {
            "bytes_per_device": arg_bytes + temp,
            "temp_bytes": temp,
            "temp_method": "peak live fake-tensor bytes / chips (estimate, "
                           "even sharding; plain versions: upper bound)",
            "argument_bytes": arg_bytes,
            "argument_tensors": n_tensors,
            "output_bytes": tr.output_bytes / chips,
            "peak_bytes": arg_bytes + temp,
        },
        "roofline": _roofline(flops, nbytes, wire),
        "model_flops_global": mflops,
        "useful_flops_ratio": mflops / tr.flops if tr.flops else 0.0,
    }


def cell_path(arch, shape_name, multi_pod, variant="baseline") -> Path:
    mesh = "multi" if multi_pod else "single"
    return RESULTS_DIR / f"{arch}__{shape_name}__{mesh}__{variant}.json"


def run_cell(arch, shape_name, multi_pod, sizes, *, force=False,
             variant="baseline", composed=None, traces=None) -> dict:
    """One cell of the CLI under mesh axis ``sizes``, cached as JSON; a
    cell that cannot be planned records its traceback."""
    out = cell_path(arch, shape_name, multi_pod, variant)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists() and not force:
        return json.loads(out.read_text())
    try:
        result = plan_cell(get_config(arch), SHAPES[shape_name], sizes,
                           variant=variant, composed=composed,
                           traces=traces)
    except Exception:
        result = {"arch": arch, "shape": shape_name,
                  "mesh": mesh_name(sizes),
                  "error": traceback.format_exc(limit=8)}
    out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--composed", action="store_true",
                    help="compose every selected cell's cost (default: "
                         "the cells the module docstring names)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    sizes = {mp: production_sizes(mp) for mp in meshes}
    traces: dict = {}
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.perf_counter()
                r = run_cell(arch, shape, mp, sizes[mp], force=args.force,
                             variant=args.variant,
                             composed=True if args.composed else None,
                             traces=traces)
                status = ("SKIP " + r.get("skipped", "")) \
                    if "skipped" in r else (
                    "ERROR" if "error" in r else
                    f"ok dom={r['roofline']['dominant']} "
                    f"tc={r['roofline']['t_compute_s']:.3e} "
                    f"tm={r['roofline']['t_memory_s']:.3e} "
                    f"tx={r['roofline']['t_collective_s']:.3e} "
                    f"GB={r['memory']['bytes_per_device'] / 1e9:.2f} "
                    f"useful={r['useful_flops_ratio']:.3f}")
                print(f"[{time.perf_counter() - t0:7.1f}s] {arch:18s} "
                      f"{shape:12s} {'2x16x16' if mp else '16x16':8s} "
                      f"{status}", flush=True)
                if "error" in r:
                    print(r["error"], flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)


if __name__ == "__main__":
    main()
