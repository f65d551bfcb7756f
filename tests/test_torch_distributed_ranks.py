"""The port's ``distributed/`` across processes: gloo ranks spawned on the
CPU (``tests/_torch_dist.py``, a ``file://`` rendezvous under ``tmp_path``,
each spawn joined within 120 s), held against the reference's one-device
oracles computed here on the same numpy inputs: ``reference_decode_attn``
(the bound its own ``test_seq_sharded_flash_decode`` holds the sharded
decode to, 1e-5), ``unpipelined_reference`` (1e-5, its
``test_pipeline_matches_reference``), ``compressed_psum``'s formula over
the reference's ``quantize_int8`` (1e-6), and the saved tensors of a
checkpoint restored under a mesh (bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.distributed.compression import dequantize_int8, quantize_int8
from repro.distributed.flash_decode import reference_decode_attn
from repro.distributed.pipeline import unpipelined_reference
from repro_torch.checkpoint import LSMCheckpointStore
from repro_torch.configs import get_config
from repro_torch.distributed.pipeline import \
    unpipelined_reference as port_unpipelined
from repro_torch.distributed.sharding import (P, axis_sizes, local_slice,
                                              param_specs, sanitize_spec,
                                              zero1_specs)
from repro_torch.models import init_model
from repro_torch.training.tree import leaf_paths

DECODE_TOL = 1e-5
PIPE_TOL = 1e-5
PSUM_TOL = 1e-6


@pytest.mark.parametrize("world,shape,axes,pos,heads", [
    # the reference test's shapes and positions, on 4 and on 2 ranks
    (4, (4,), ("model",), (63, 29), (4, 4)),
    (2, (2,), ("model",), (63, 29), (4, 4)),
    # sequence 0 ends in the first slice, so ranks 1-3 hold none of it;
    # GQA, 2 query heads per kv head, over a 2 x 2 mesh's "model" axis
    (4, (4,), ("model",), (5, 40), (4, 2)),
    (4, (2, 2), ("data", "model"), (5, 63), (4, 2)),
])
def test_seq_sharded_decode_matches_reference(tmp_path, world, shape, axes,
                                              pos, heads):
    b, dh, t = 2, 16, 64
    h, hk = heads
    q = td.seeded((b, h, dh), 0)
    k = td.seeded((b, t, hk, dh), 1)
    v = td.seeded((b, t, hk, dh), 2)
    pos = np.asarray(pos, np.int32)
    got = td.run_ranks(td.decode_rank, world, tmp_path, q, k, v,
                       pos.astype(np.int64), shape, axes, "model")
    want = np.asarray(reference_decode_attn(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jnp.asarray(pos)))
    for r, out in enumerate(got):
        err = float(np.max(np.abs(out.numpy() - want)))
        assert err < DECODE_TOL, (r, err)
        assert torch.equal(out, got[0])     # the same on every rank


def test_compressed_psum_matches_reference_formula(tmp_path):
    xs = [td.seeded((64, 33), 10 + r) * (r + 1) for r in range(4)]
    got = td.run_ranks(td.psum_rank, 4, tmp_path, xs)
    # the reference's compressed_psum body, one device: every rank's
    # dequantized payload summed, over the rank count
    parts = [dequantize_int8(*quantize_int8(jnp.asarray(x))) for x in xs]
    want = np.asarray(sum(parts[1:], parts[0]) / len(xs))
    for r, res in enumerate(got):
        assert float(np.max(np.abs(res["mean"].numpy() - want))) < PSUM_TOL
        assert torch.equal(res["mean"], got[0]["mean"])
        # the payload gathered is int8, beside one fp32 scale a rank
        assert res["wire"] == ["torch.int8", "torch.float32"], r


def test_pipeline_matches_unpipelined_reference(tmp_path):
    s, mb, d = 4, 2, 16
    w = td.seeded((s, d, d), 0) * 0.3
    # M 6 (the reference test's), M 1, and M 3 < S
    xs = [td.seeded((m, mb, d), m) for m in (6, 1, 3)]
    got = td.run_ranks(td.pipeline_rank, 4, tmp_path, w, xs)

    def stage(p, h):
        return jnp.tanh(h @ p["w"])
    for i, x in enumerate(xs):
        want = np.asarray(unpipelined_reference(stage, {"w": jnp.asarray(w)},
                                                jnp.asarray(x)))
        # the port's oracle, which the card's phase holds its stages to
        oracle = port_unpipelined(td._tanh_stage, {"w": torch.from_numpy(w)},
                                  torch.from_numpy(x))
        assert float(np.max(np.abs(oracle.numpy() - want))) < PIPE_TOL
        for r, res in enumerate(got):
            assert res[i].shape == x.shape
            err = float(np.max(np.abs(res[i].numpy() - want)))
            assert err < PIPE_TOL, (x.shape[0], r, err)
            assert torch.equal(res[i], got[0][i])


def _pages_of(box, shape, itemsize, page_bytes):
    """Pages holding the box's elements, from the element indices."""
    idx = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    idx = idx[tuple(slice(a, b) for a, b in box)].ravel()
    return set((idx * itemsize // page_bytes).tolist())


@pytest.mark.parametrize("shape,axes,spec_kind", [
    ((2,), ("model",), "param"),
    ((2, 2), ("data", "model"), "param"),
    ((2, 2), ("data", "model"), "zero1"),
])
def test_restore_under_mesh_reads_own_slices(tmp_path, shape, axes,
                                             spec_kind):
    cfg = get_config("whisper_tiny").smoke()
    params = init_model(cfg, seed=3, compute_device="cpu")
    page = 4096
    store = LSMCheckpointStore(tmp_path / "ckpt", page_bytes=page,
                               compute_device="cpu")
    store.save(0, params)
    # a second save rewrites only the token embedding: its pages move to a
    # segment of their own
    params["embed"].add_(1.0)
    store.save(1, params)
    got = td.run_ranks(td.restore_rank, int(np.prod(shape)), tmp_path,
                       str(tmp_path / "ckpt"), page, shape, axes, spec_kind)

    class Mesh:
        pass
    mesh = Mesh()
    mesh.shape = dict(zip(axes, shape))
    specs = (param_specs(cfg, params) if spec_kind == "param"
             else zero1_specs(cfg, params, mesh))
    flat = leaf_paths(params)
    spec_of = dict(leaf_paths(specs))
    sizes = axis_sizes(mesh)
    # newest version of each page at the last step
    newest = {}
    for seq in sorted(store.locator):
        seg, name, pg = store.locator[seq]
        newest[(name, pg)] = seg
    sharded = 0
    for res in got:
        coord = dict(zip(axes, res["coord"]))
        local = dict(leaf_paths(res["local"]))
        want_pages, want_segs = 0, set()
        for path, full in flat:
            spec = sanitize_spec(mesh, spec_of[path], tuple(full.shape))
            box = local_slice(sizes, coord, spec, tuple(full.shape))
            shard, placements = local[path]
            want = full[tuple(slice(a, b) for a, b in box)]
            assert shard.dtype == full.dtype and torch.equal(shard, want), \
                (path, coord)
            sharded += shard.numel() < full.numel()
            pages = _pages_of(box, tuple(full.shape), full.element_size(),
                              page)
            want_pages += len(pages)
            name = "/".join(path)
            want_segs |= {newest[(name, p)] for p in pages}
        assert res["stats"]["pages_read"] == want_pages
        assert res["stats"]["segments_touched"] == len(want_segs)
    assert sharded > 0


@pytest.mark.parametrize("shape,axes,spec", [
    ((2, 2), ("data", "model"), ("data", "model")),
    ((2,), ("model",), (None, "model")),
])
def test_restore_under_mesh_allocates_its_shard(tmp_path, shape, axes, spec):
    # one 8 MiB leaf: each rank's host allocation during the restore stays
    # near its own shard (a quarter or a half of the leaf), never the leaf:
    # the shard plus a few pages in flight
    leaf_shape, page = (1024, 2048), 1 << 16
    w = torch.from_numpy(td.seeded(leaf_shape, 5))
    store = LSMCheckpointStore(tmp_path / "ckpt", page_bytes=page,
                               compute_device="cpu")
    store.save(0, {"w": w})
    world = int(np.prod(shape))
    got = td.run_ranks(td.restore_leaf_rank, world, tmp_path,
                       str(tmp_path / "ckpt"), page, shape, axes,
                       leaf_shape, spec)
    sizes = dict(zip(axes, shape))
    shard_bytes = w.numel() * w.element_size() // world
    for res in got:
        box = local_slice(sizes, dict(zip(axes, res["coord"])), P(*spec),
                          leaf_shape)
        shard = res["local"]["w"][0]
        assert torch.equal(shard, w[tuple(slice(a, b) for a, b in box)])
        assert res["stats"]["pages_read"] == len(_pages_of(
            box, leaf_shape, w.element_size(), page))
        peak = res["stats"]["host_peak_bytes"]
        assert shard_bytes <= peak < shard_bytes + 16 * page, (peak,
                                                              shard_bytes)
