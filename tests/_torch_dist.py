"""Rank functions of the port's multi-process tests
(``tests/test_torch_distributed_ranks.py``).

Each runs in a process of its own, started by ``repro_torch.distributed.
comm.start`` into a gloo group joined through a ``file://`` rendezvous, so
it lives in an importable module and imports neither JAX nor the JAX
package.  Each saves what it computed to ``<out>/rank<r>.pt``; the test
reads the files and holds them against the reference's oracles in its own
process.
"""

import tracemalloc
from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed import comm
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.flash_decode import seq_sharded_decode_attn
from repro_torch.distributed.pipeline import pipeline_apply

JOIN_S = 120     # each spawn's own time limit


def run_ranks(fn, world: int, tmp_path: Path, *args) -> list:
    """``fn(rank, world, out, *args)`` on ``world`` gloo ranks; each rank's
    saved result, in rank order."""
    out = tmp_path / f"out_{fn.__name__}"
    out.mkdir()
    comm.join(comm.start(fn, world, (str(out), *args), backend="gloo",
                         init_file=tmp_path / f"init_{fn.__name__}"),
              JOIN_S)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _mesh(shape, axes):
    torch.set_num_threads(1)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _save(out: str, rank: int, obj) -> None:
    torch.save(obj, Path(out) / f"rank{rank}.pt")


def decode_rank(rank, world, out, q, k, v, pos, shape, axes, axis):
    """This rank's slice of the global cache through
    ``seq_sharded_decode_attn``."""
    mesh = _mesh(shape, axes)
    n = comm.axis_size(mesh, axis)
    t_loc = k.shape[1] // n
    lo = comm.axis_index(mesh, axis) * t_loc
    got = seq_sharded_decode_attn(
        mesh, torch.from_numpy(q), torch.from_numpy(k[:, lo:lo + t_loc]),
        torch.from_numpy(v[:, lo:lo + t_loc]), torch.from_numpy(pos),
        axis=axis)
    _save(out, rank, got)


def psum_rank(rank, world, out, xs):
    """``compressed_psum`` of rank r's ``xs[r]`` over a 4-wide "pod" mesh,
    with the dtypes that ``comm.all_gather`` was handed."""
    mesh = _mesh((world,), ("pod",))
    wire = []
    gather = comm.all_gather

    def recording(x, mesh, axis):
        wire.append(str(x.dtype))
        return gather(x, mesh, axis)
    comm.all_gather = recording
    try:
        got = compressed_psum(torch.from_numpy(xs[rank]), mesh, "pod")
    finally:
        comm.all_gather = gather
    _save(out, rank, {"mean": got, "wire": wire})


def _tanh_stage(p, h):
    return torch.tanh(h @ p["w"])


def pipeline_rank(rank, world, out, w, xs):
    """``pipeline_apply`` of the reference test's ``tanh(h @ w)`` stages
    over a 4-wide "pipe" mesh, one call for each input of ``xs``."""
    mesh = _mesh((world,), ("pipe",))
    got = [pipeline_apply(mesh, _tanh_stage, {"w": torch.from_numpy(w[rank])},
                          torch.from_numpy(x), n_micro=x.shape[0])
           for x in xs]
    _save(out, rank, got)


def _restore(root, page_bytes, mesh, like, specs):
    """Restore the store at ``root`` (pages of ``page_bytes``) under
    ``mesh`` by ``specs`` sanitized against it, with the host memory that
    Python's allocators traced at its peak beside the stats: of a second
    restore, since the first imports what DTensor's first use imports."""
    from repro_torch.checkpoint import LSMCheckpointStore
    from repro_torch.distributed.sharding import sanitize_spec
    from repro_torch.training.tree import tree_map

    specs = tree_map(
        lambda leaf, spec: sanitize_spec(mesh, spec, tuple(leaf.shape)),
        like, specs)
    store = LSMCheckpointStore(root, page_bytes=page_bytes,
                               compute_device="cpu")
    store.restore(treedef_like=like, mesh=mesh, specs=specs)
    tracemalloc.start()
    try:
        tree, stats = store.restore(treedef_like=like, mesh=mesh,
                                    specs=specs)
        stats["host_peak_bytes"] = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    local = tree_map(lambda d: (d.to_local(), tuple(map(str, d.placements))),
                     tree)
    return {"coord": mesh.get_coordinate(), "local": local, "stats": stats}


def restore_rank(rank, world, out, root, page_bytes, shape, axes, spec_kind):
    """Restore under a gloo mesh of ``shape`` by the parameter (or ZeRO-1)
    specs of whisper-tiny's smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_specs, zero1_specs
    from repro_torch.models import model_specs
    from repro_torch.training.tree import tree_map

    mesh = _mesh(shape, axes)
    cfg = get_config("whisper_tiny").smoke()
    like = tree_map(lambda s: torch.empty(s[1]), model_specs(cfg))
    specs = (param_specs(cfg, like) if spec_kind == "param"
             else zero1_specs(cfg, like, mesh))
    _save(out, rank, _restore(root, page_bytes, mesh, like, specs))


def restore_leaf_rank(rank, world, out, root, page_bytes, shape, axes,
                      leaf_shape, spec):
    """Restore one saved leaf ``w`` of ``leaf_shape`` under a gloo mesh of
    ``shape`` by ``spec``."""
    from repro_torch.distributed.sharding import P

    mesh = _mesh(shape, axes)
    _save(out, rank, _restore(root, page_bytes, mesh,
                              {"w": torch.empty(leaf_shape, device="meta")},
                              {"w": P(*spec)}))


def seeded(shape, seed: int, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)
