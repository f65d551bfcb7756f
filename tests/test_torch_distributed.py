"""The port's ``distributed/`` and ``launch/{mesh,specs}`` against the JAX
package on the CPU, in one process (the multi-process parts are
``test_torch_distributed_ranks.py``).

* Rules and cells: for all 10 archs, ``param_specs``, ``zero1_specs``,
  ``cache_specs`` (with and without ``batch1``), ``train_batch_specs`` and
  ``decode_input_specs`` equal the reference's leaf for leaf under both
  variant switches (the reference's environment variables, the port's
  keyword arguments), over a (16, 16) and a (2, 16, 16) stand-in mesh;
  then ``train_specs``, ``prefill_specs`` and ``decode_specs`` for every
  arch, shape and production mesh (the reference's under an
  ``AbstractMesh``): shapes, dtypes and sanitized specs equal, and
  ``needs_fsdp``.  whisper's cross cache differs by design: 1,504 rows in
  the port (``models.blocks.cross_rows``), 1,500 in the reference.
* Slice layout: in a JAX subprocess with 8 host devices, ``local_slice``
  at every coordinate of a (2, 2, 2) mesh equals ``NamedSharding.
  devices_indices_map`` for every spec the rules give qwen3-1.7b's and
  deepseek-v2-lite's smoke trees, caches and batches.
* Meshes: ``make_production_mesh`` under the fake backend has the
  reference's axis names and sizes (the reference's over 512 forced host
  devices), in a subprocess.
* Compression: ``quantize_int8``/``dequantize_int8`` bitwise; 50 steps of
  ``compress_tree`` within one quantum per element of the reference's; the
  reference's error-feedback sum test mirrored.
* The compressed train step: 3 fp32 steps of a smoke qwen3 against the
  reference's ``compress_tree`` + ``adamw_update`` with ``ef`` carried by
  hand, within ``test_torch_train_steps.py``'s tolerances (the loss 1e-5
  relative, parameters 6·lr, at most 1e-3 of them apart by 1e-6), the grad
  norm within 1e-5 relative plus one quantum of the largest leaf (an
  element whose int8 rounding flips between the two sides' gradients moves
  by one quantum) and ``ef`` within one quantum (beside the gradients' own
  2e-5 of each leaf's largest element); and the record of the
  reference's own step dropping
  ``ef`` (``repro/training/optimizer.py:66``).
* Flash decode: ``_local_partial`` of each slice within 1e-6 of the
  reference's (o, l, m); paged_attention's plain ``return_lse`` against a
  direct log-sum-exp (1e-5), -1e30 for an empty row, the output unchanged.
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.sharding as ref_sharding
import repro.launch.specs as ref_specs
import repro_torch.configs as port_configs
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.distributed.compression import compress_tree as ref_compress
from repro.distributed.compression import dequantize_int8 as ref_dequant
from repro.distributed.compression import quantize_int8 as ref_quant
from repro.distributed.flash_decode import _local_partial as ref_partial
from repro.distributed.flash_decode import \
    reference_decode_attn as ref_decode_attn
from repro.models import init_model as ref_init
from repro.models import train_loss as ref_train_loss
from repro.training import AdamWConfig as RefAdamW
from repro.training import adamw_update as ref_adamw
from repro.training import init_opt_state as ref_init_opt
from repro.training import make_train_step as ref_make_step
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (compress_tree,
                                                 dequantize_int8,
                                                 quantize_int8)
from repro_torch.distributed.flash_decode import (_local_partial,
                                                  reference_decode_attn)
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.launch import specs
from repro_torch.models import params_from_jax
from repro_torch.models.blocks import cross_rows
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.tree import leaf_paths

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
PARTIAL_TOL = 1e-6
GRAD_RTOL = 2e-5     # test_torch_training.py's gradient bound
LSE_TOL = 1e-5


class FakeMesh:
    """The reference tests' stand-in: a name -> size ``shape`` dict."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _ref_flat(tree) -> dict:
    """key path -> leaf of a reference tree (PartitionSpecs as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in flat}


def _port_flat(tree) -> dict:
    if isinstance(tree, tuple) and not isinstance(tree, sharding.P):
        return {(i, *p): v for i, t in enumerate(tree)
                for p, v in _port_flat(t).items()}
    return dict(leaf_paths(tree))


def _specs_of(flat: dict) -> dict:
    return {k: tuple(v) for k, v in flat.items()}


def _set_variant(monkeypatch, attn: bool, seq: bool) -> None:
    for name, on in (("REPRO_ATTN_REPLICATED", attn),
                     ("REPRO_SEQ_SHARD", seq)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)


@functools.lru_cache(maxsize=None)
def _ref_params_shape(arch: str):
    return jax.eval_shape(functools.partial(ref_init, get_config(arch)),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rule_specs_match_reference(arch, monkeypatch):
    rcfg, cfg = get_config(arch), port_configs.get_config(arch)
    rshape = _ref_params_shape(arch)
    pshape = specs.params_shape(cfg)
    assert set(_port_flat(pshape)) == set(_ref_flat(rshape))
    for attn, seq in VARIANTS:
        _set_variant(monkeypatch, attn, seq)
        assert _specs_of(_port_flat(sharding.param_specs(
            cfg, pshape, attn_replicated=attn))) == \
            _specs_of(_ref_flat(ref_sharding.param_specs(rcfg, rshape)))
        for sizes in MESHES.values():
            mesh = FakeMesh(sizes)
            assert _specs_of(_port_flat(sharding.zero1_specs(
                cfg, pshape, mesh, attn_replicated=attn))) == _specs_of(
                _ref_flat(ref_sharding.zero1_specs(rcfg, rshape, mesh)))
            for batch1 in (False, True):
                assert _specs_of(sharding.cache_specs(
                    cfg, mesh, batch1=batch1)) == _specs_of(
                    ref_sharding.cache_specs(rcfg, mesh, batch1=batch1))
            assert _specs_of(sharding.train_batch_specs(
                cfg, mesh, seq_shard=seq)) == _specs_of(
                ref_sharding.train_batch_specs(rcfg, mesh))
            assert _specs_of(sharding.decode_input_specs(cfg, mesh)) == \
                _specs_of(ref_sharding.decode_input_specs(rcfg, mesh))
            assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(mesh)


def _cell(kind):
    return {"train": "train_specs", "prefill": "prefill_specs",
            "decode": "decode_specs"}[kind]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_specs_match_reference(arch, mesh_name, monkeypatch):
    _set_variant(monkeypatch, False, False)
    rcfg, cfg = get_config(arch), port_configs.get_config(arch)
    sizes = MESHES[mesh_name]
    rmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    mesh = FakeMesh(sizes)
    assert specs.needs_fsdp(cfg, mesh) == ref_specs.needs_fsdp(rcfg, rmesh) \
        == (arch == "deepseek_v2_236b")
    for shape in SHAPES.values():
        fn = _cell(shape.kind)
        want = _ref_flat(getattr(ref_specs, fn)(rcfg, shape, rmesh))
        got = _port_flat(getattr(specs, fn)(cfg, shape, mesh))
        assert set(got) == set(want), (shape.name, set(got) ^ set(want))
        for path, sds in want.items():
            leaf = got[path]
            wshape = tuple(sds.shape)
            if arch == "whisper_tiny" and path[-1] in ("cross_k", "cross_v"):
                # the port's cross cache: whole decode pages
                wshape = wshape[:2] + (cross_rows(cfg),) + wshape[3:]
            assert leaf.shape == wshape, (shape.name, path)
            assert str(leaf.dtype).removeprefix("torch.") == str(sds.dtype)
            assert tuple(leaf.spec) == tuple(sds.sharding.spec), \
                (shape.name, path, leaf.spec, sds.sharding.spec)


def test_placements_follow_mesh_order():
    mesh = FakeMesh(MESHES["2x16x16"])
    n = 0
    for arch in ARCH_IDS:
        cfg = port_configs.get_config(arch)
        pshape = specs.params_shape(cfg)
        for tree in (sharding.zero1_specs(cfg, pshape, mesh),
                     sharding.cache_specs(cfg, mesh, batch1=True),
                     sharding.cache_specs(cfg, mesh),
                     sharding.train_batch_specs(cfg, mesh, seq_shard=True)):
            for _, spec in leaf_paths(tree):
                pl = sharding.placements(mesh, spec)
                n += 1
                for j, name in enumerate(mesh.shape):
                    dims = [i for i, e in enumerate(spec)
                            if name in sharding._axes(e)]
                    want = Shard(dims[0]) if dims else Replicate()
                    assert pl[j] == want, (spec, pl)
    assert n > 100
    with pytest.raises(ValueError):
        sharding.placements(mesh, sharding.P(("data", "pod"), None))


def _run(code: str, n_dev: int) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_local_slice_matches_devices_indices_map():
    out = _run("""
        import itertools
        import jax
        from jax.sharding import NamedSharding, PartitionSpec
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding
        from repro_torch.launch.specs import params_shape, sanitize_spec
        from repro_torch.models import cache_shapes
        from repro_torch.training.tree import leaf_paths

        axes = ("pod", "data", "model")
        mesh = jax.make_mesh((2, 2, 2), axes)

        class Fake:
            shape = dict(zip(axes, (2, 2, 2)))
            axis_names = axes
        fake = Fake()
        items = []
        for arch in ("qwen3_1_7b", "deepseek_v2_lite"):
            cfg = get_config(arch).smoke()
            pshape = params_shape(cfg)
            for tree in (sharding.param_specs(cfg, pshape),
                         sharding.zero1_specs(cfg, pshape, fake)):
                spec_of = dict(leaf_paths(tree))
                items += [(spec_of[p], leaf.shape)
                          for p, leaf in leaf_paths(pshape)]
            for b, batch1 in ((4, False), (1, True)):
                cs = cache_shapes(cfg, b, 16)
                for k, spec in sharding.cache_specs(
                        cfg, fake, batch1=batch1).items():
                    items.append((spec, cs[k][0]))
            for seq_shard in (False, True):
                bs = sharding.train_batch_specs(cfg, fake,
                                                seq_shard=seq_shard)
                items += [(bs["tokens"], (4, 16)), (bs["labels"], (4, 16))]
            ds = sharding.decode_input_specs(cfg, fake)
            items += [(ds["tokens"], (4, 1)), (ds["pos"], (4,))]
        forms = set()
        for spec, shape in items:
            spec = sanitize_spec(fake, spec, tuple(shape))
            forms.add(tuple(spec))
            want = NamedSharding(mesh, PartitionSpec(*spec)
                                 ).devices_indices_map(tuple(shape))
            for coord in itertools.product(range(2), repeat=3):
                dev = mesh.devices[coord]
                w = tuple(s.indices(n)[:2]
                          for s, n in zip(want[dev], shape))
                got = sharding.local_slice(fake.shape, dict(zip(axes, coord)),
                                           spec, tuple(shape))
                assert got == w, (spec, shape, coord, got, w)
        print(len(items), len(forms))
    """, 8)
    n_items, n_forms = map(int, out.split())
    assert n_items > 100 and n_forms >= 8


def test_production_mesh_matches_reference():
    out = _run("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro.launch.mesh import make_production_mesh as ref_mesh
        from repro_torch.distributed.sharding import axis_sizes
        from repro_torch.launch.mesh import make_mesh, make_production_mesh

        for multi_pod in (False, True):
            want = ref_mesh(multi_pod=multi_pod)
            n = want.devices.size
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n)
            got = make_production_mesh(multi_pod, device_type="cpu")
            assert got.mesh_dim_names == want.axis_names, got
            assert axis_sizes(got) == dict(want.shape), axis_sizes(got)
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        m = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        assert axis_sizes(m) == {"data": 2, "model": 4}
        print("ok")
    """, 512)
    assert out.strip() == "ok"


# ---------------------------------------------------------- compression
@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0, 37.5])
def test_quantize_int8_bitwise(scale):
    x = np.random.default_rng(5).standard_normal((257, 33)).astype(
        np.float32) * scale
    rq, rs = ref_quant(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert np.asarray(ref_dequant(rq, rs)).tobytes() == \
        dequantize_int8(q, s).numpy().tobytes()


def test_compress_tree_fifty_steps_within_one_quantum():
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 32), "b": {"c": (300,), "d": (7, 5, 3)}}
    rstate, state = {}, {}
    for _ in range(50):
        g = jax.tree.map(
            lambda s: rng.standard_normal(s).astype(np.float32) * 1e-3,
            shapes, is_leaf=lambda s: isinstance(s, tuple))
        rg, rstate = ref_compress(jax.tree.map(jnp.asarray, g), rstate)
        tg, state = compress_tree(jax.tree.map(torch.from_numpy, g), state)
        for path, want in _ref_flat(rg).items():
            got = dict(leaf_paths(tg))[path]
            e32 = np.asarray(_ref_flat(rstate["ef"])[path])
            # one quantum of the leaf this step: max|g + ef| / 127
            quantum = float(np.max(np.abs(
                np.asarray(want) + e32))) / 127.0 + 1e-12
            assert np.max(np.abs(got.numpy() - np.asarray(want))) <= quantum
            ef = dict(leaf_paths(state["ef"]))[path].numpy()
            assert np.max(np.abs(ef - e32)) <= quantum


def test_error_feedback_preserves_sum():
    """The reference's ``test_error_feedback_preserves_sum``, on the port."""
    rng = np.random.default_rng(2)
    true = torch.from_numpy(rng.standard_normal(256).astype(np.float32)) \
        * 1e-3
    opt_state = {}
    acc = torch.zeros(256)
    for _ in range(50):
        g, opt_state = compress_tree({"g": true}, opt_state)
        acc = acc + g["g"]
    assert float(torch.max(torch.abs(acc / 50 - true))) < 5e-4


def _qwen3_smoke():
    cfg = get_config("qwen3_1_7b").smoke()
    tcfg = port_configs.get_config("qwen3_1_7b").smoke()
    rp = jax.jit(ref_init, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, rp


def _batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_compressed_train_step_carries_error_feedback():
    cfg, tcfg, rp = _qwen3_smoke()
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    lr = AdamWConfig().lr

    @jax.jit
    def ref_step(p, st, batch):
        # the reference's compress_grads step, with ef carried by hand
        loss, grads = jax.value_and_grad(
            lambda p: ref_train_loss(cfg, p, batch))(p)
        # each leaf's quantum this step: max|g + ef| / 127
        ef = st.get("ef", jax.tree.map(jnp.zeros_like, grads))
        quantum = jax.tree.map(lambda g, e: jnp.max(jnp.abs(g + e)) / 127.0,
                               grads, ef)
        grads, st = ref_compress(grads, st)
        p, new, gnorm = ref_adamw(RefAdamW(), p, grads, st)
        return p, {**new, "ef": st["ef"]}, loss, gnorm, quantum
    step = make_train_step(tcfg, AdamWConfig(), compress_grads=True,
                           compute_device="cpu")
    ro, to = ref_init_opt(rp), init_opt_state(tp)
    for i in range(3):
        batch = _batch(cfg, i)
        rp, ro, rloss, rnorm, quantum = ref_step(rp, ro, batch)
        tp, to, tm = step(tp, to, batch)
        assert abs(float(tm["loss"]) - float(rloss)) <= 1e-5 * abs(
            float(rloss)), i
        # an element whose quantization flips moves the norm by at most
        # its quantum
        qmax = max(float(q) for q in jax.tree.leaves(quantum))
        assert abs(float(tm["grad_norm"]) - float(rnorm)) <= 1e-5 * abs(
            float(rnorm)) + qmax, i
    assert int(to["step"]) == 3 and set(to) == {"m", "v", "step", "ef"}
    port = _port_flat(tp)
    apart = total = 0
    for path, leaf in _ref_flat(rp).items():
        d = np.abs(port[path].numpy().astype(np.float64)
                   - np.asarray(leaf, np.float64))
        assert d.max() <= 6 * lr, (path, d.max())
        apart += int((d > 1e-6).sum())
        total += d.size
    assert apart <= 1e-3 * total, (apart, total)
    ef = _port_flat(to["ef"])
    last_quantum = _ref_flat(quantum)
    for path, e in _ref_flat(ro["ef"]).items():
        assert ef[path].dtype == torch.float32
        # one quantum where an int8 rounding flips, beside the gradients'
        # own difference (2e-5 of the leaf's largest element,
        # test_torch_training.py): 127 * 2e-5 quanta
        bound = float(last_quantum[path]) * (1 + 127 * GRAD_RTOL)
        assert np.max(np.abs(ef[path].numpy() - np.asarray(e))) <= bound, \
            path


def test_reference_train_step_drops_error_feedback():
    """A reference-side fault the port does not copy: the reference's
    ``adamw_update`` returns ``{"m", "v", "step"}``
    (``repro/training/optimizer.py:66``), so its
    ``make_train_step(compress_grads=True)`` loses ``opt_state["ef"]``
    every step and its residual never outlives one; the port's step keeps
    it."""
    cfg, tcfg, rp = _qwen3_smoke()
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    _, ro, _ = jax.jit(ref_make_step(cfg, RefAdamW(), compress_grads=True))(
        rp, ref_init_opt(rp), _batch(cfg, 0))
    assert "ef" not in ro
    _, to, _ = make_train_step(tcfg, AdamWConfig(), compress_grads=True,
                               compute_device="cpu")(
        tp, init_opt_state(tp), _batch(cfg, 0))
    assert "ef" in to


# ---------------------------------------------------------- flash decode
def test_local_partial_matches_reference():
    rng = np.random.default_rng(0)
    b, h, hk, dh, t = 3, 8, 2, 16, 64
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    pos = np.asarray([t - 1, 29, 3], np.int32)
    scale = dh ** -0.5
    for t0 in range(0, t, 16):
        want = ref_partial(jnp.asarray(q), jnp.asarray(k[:, t0:t0 + 16]),
                           jnp.asarray(v[:, t0:t0 + 16]), t0,
                           jnp.asarray(pos), scale)
        got = _local_partial(torch.from_numpy(q),
                             torch.from_numpy(k[:, t0:t0 + 16]),
                             torch.from_numpy(v[:, t0:t0 + 16]), t0,
                             torch.from_numpy(pos), scale)
        for name, g, w in zip("olm", got, want):
            assert g.shape == w.shape, name
            assert np.max(np.abs(g.numpy() - np.asarray(w))) <= \
                PARTIAL_TOL * max(1.0, float(np.max(np.abs(w)))), (t0, name)


@pytest.mark.parametrize("pos", [(63, 29), (0, 5)])
def test_reference_decode_attn_matches_reference(pos):
    """The port's one-device oracle against the reference's, on the
    reference test's shapes (GQA too)."""
    rng = np.random.default_rng(4)
    b, h, hk, dh, t = 2, 4, 2, 16, 64
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, dh)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(ref_decode_attn(*(jnp.asarray(x)
                                        for x in (q, k, v, pos))))
    got = reference_decode_attn(*(torch.from_numpy(x)
                                  for x in (q, k, v, pos)))
    assert float(np.max(np.abs(got.numpy() - want))) <= PARTIAL_TOL


@pytest.mark.parametrize("window", [None, 5])
def test_paged_plain_lse(window):
    rng = np.random.default_rng(1)
    b, hq, hkv, d, ps, maxp = 4, 8, 2, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((9, ps, hkv, d)).astype(
        np.float32))
    vp = torch.from_numpy(rng.standard_normal((9, ps, hkv, d)).astype(
        np.float32))
    table = torch.from_numpy(rng.integers(0, 9, (b, maxp)).astype(np.int32))
    lengths = torch.tensor([0, 1, 13, 32], dtype=torch.int32)
    out, lse = paged_attention_plain(q, kp, vp, table, lengths, window=window,
                                     return_lse=True)
    assert torch.equal(out, paged_attention_plain(q, kp, vp, table, lengths,
                                                  window=window))
    assert lse.shape == (b, hq) and lse.dtype == torch.float32
    for i in range(b):
        n = int(lengths[i])
        lo = max(0, n - window) if window else 0
        if n == 0:
            assert torch.all(lse[i] == -1e30)
            continue
        toks = torch.arange(lo, n)
        k = kp[table[i, toks // ps].long(), toks % ps]       # [T, Hkv, D]
        for h in range(hq):
            s = (k[:, h // (hq // hkv)] @ q[i, h]) * d ** -0.5
            assert abs(float(lse[i, h] - torch.logsumexp(s, 0))) <= LSE_TOL


def test_distributed_reads_no_environment():
    """The reference's two environment switches are keyword arguments in
    the port: nothing under ``distributed/`` reads ``os.environ``."""
    root = Path(SRC) / "repro_torch" / "distributed"
    files = sorted(root.glob("*.py"))
    assert {f.name for f in files} >= {
        "__init__.py", "comm.py", "compression.py", "flash_decode.py",
        "pipeline.py", "sharding.py"}
    for f in files:
        text = f.read_text()
        assert "os.environ" not in text and "getenv" not in text, f.name
