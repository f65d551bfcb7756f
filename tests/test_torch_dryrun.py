"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``: its argument bytes against the
reference's shard shapes on both production meshes, its model FLOPs
against the reference's formula, its collective accounting against a hand
count, and the microcell the reference's own test lowers."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import get_config as ref_get_config
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SMALL = ShapeSpec("t", 32, 8, "train")


def _run(code: str, n_dev: int) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_dryrun_microcell_multipod():
    """The counterpart of ``test_multidevice.py``'s microcell: qwen3's smoke
    config on a (2, 2, 2) pod x data x model mesh."""
    cfg = get_config("qwen3_1_7b").smoke()
    r = dryrun.plan_cell(cfg, SMALL, {"pod": 2, "data": 2, "model": 2})
    assert r["chips"] == 8 and r["mesh"] == "2x2x2"
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert 0 < r["useful_flops_ratio"] < 1
    counts = r["collectives"]["per_op_counts"]
    assert counts["all-reduce"] > 0 and counts["reduce-scatter"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert set(r) >= {"arch", "shape", "variant", "mesh", "chips", "fsdp",
                      "flops_per_device", "bytes_per_device",
                      "collective_wire_bytes_per_device", "collectives",
                      "memory", "roofline", "model_flops_global",
                      "useful_flops_ratio", "trace_s"}


def test_argument_bytes_equal_reference_shard_shapes():
    """Per-device argument bytes for every arch and shape on both production
    meshes against sum(NamedSharding.shard_shape x itemsize) over the
    reference's spec leaves, nothing compiled; the only allowed difference
    is whisper's cross cache, 1,504 rows in the port against 1,500."""
    out = _run("""
        import functools, math
        import jax
        import repro.launch.specs as ref_specs
        from repro.configs import SHAPES, get_config as ref_config
        from repro.configs.registry import ARCH_IDS
        from repro.launch.mesh import make_production_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun

        ref_specs.params_shape = functools.lru_cache(None)(
            ref_specs.params_shape)
        funcs = {"train": ref_specs.train_specs,
                 "prefill": ref_specs.prefill_specs,
                 "decode": ref_specs.decode_specs}
        checked = 0
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            sizes = dict(mesh.shape)
            for arch in ARCH_IDS:
                for name, shape in SHAPES.items():
                    cfg = get_config(arch)
                    if dryrun.skip_reason(cfg, shape):
                        continue
                    rcfg = ref_config(arch)
                    want = sum(
                        math.prod(x.sharding.shard_shape(x.shape))
                        * x.dtype.itemsize
                        for x in jax.tree.leaves(
                            funcs[shape.kind](rcfg, shape, mesh)))
                    args = dryrun.cell_args(cfg, shape, sizes)
                    got, _ = dryrun.argument_bytes(sizes, args)
                    allowed = 0
                    if cfg.family == "encdec" and shape.kind == "decode":
                        allowed = sum(
                            dryrun.leaf_bytes(sizes, args["cache"][k])
                            * (1504 - 1500) // 1504
                            for k in ("cross_k", "cross_v"))
                    assert got - want == allowed, (arch, name, sizes, got,
                                                   want, allowed)
                    checked += 1
        print(checked)
    """, 512)
    long = sum(get_config(a).sub_quadratic for a in ARCH_IDS)
    assert long >= 2
    assert int(out.split()[-1]) == 2 * (len(ARCH_IDS) * 3 + long)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference_formula(arch):
    """The reference's ``lower_cell``: 6·N·B·S training, 2·N·B·S a prefill,
    2·N·B a decode step, N the reference config's active parameters."""
    n = ref_get_config(arch).active_param_count()
    cfg = get_config(arch)
    for shape in SHAPES.values():
        want = 6 * n * shape.global_batch * (
            shape.seq_len if shape.kind == "train" else 1)
        if shape.kind == "prefill":
            want = 2 * n * shape.global_batch * shape.seq_len
        if shape.kind == "decode":
            want = 2 * n * shape.global_batch
        assert dryrun.model_flops(cfg, shape) == want


def test_collectives_equal_hand_count():
    """qwen3's smoke config (2 layers, d 128, ff 256, vocab 512, fp32, tied
    embeddings) training at B 8 x S 32 on data 2 x model 2, no FSDP.

    Parameters: every one of the 13 leaves keeps ZeRO-1's 'data' on its
    moments (each has a free dimension 2 divides), so each takes one
    reduce-scatter of its gradient's half (wire: half its local bytes)
    and one all-gather of its local bytes (wire: half of them).  Local
    bytes (fp32): embed 256 x 128; final_norm 128; k_norm, q_norm 2 x 64
    each; wq, wk, wv, w_gate, w_up 2 x 128 x 128 each; wo, w_down 2 x 128
    x 128 each; attn_norm, mlp_norm 2 x 128 each.

    Activations over 'model' (g 2: wire = the bytes), 4 x 32 = 128 local
    tokens: the embedding's forward and the tied head's backward (128 x
    128 fp32 each); wo and w_down, 2 layers x (forward, remat's forward,
    backward) each (128 x 128 fp32); the loss's 3 all-reduces of 128
    fp32."""
    cfg = get_config("qwen3_1_7b").smoke()
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.n_heads * cfg.head_dim, cfg.tie_embeddings) == \
        (2, 128, 256, 512, 256, True)
    sizes = {"data": 2, "model": 2}
    args = dryrun.cell_args(cfg, SMALL, sizes, fsdp=False)
    got = dryrun.collective_plan(cfg, SMALL, sizes, args)

    local = 4 * (256 * 128 + 128 + 2 * 2 * 64 + 5 * 2 * 128 * 128
                 + 2 * 2 * 128 * 128 + 2 * 2 * 128)
    act = 128 * 128 * 4
    assert got["per_op_counts"] == {"all-reduce": 2 + 12 + 3,
                                    "all-gather": 13, "reduce-scatter": 13}
    assert got["reduce-scatter"] == local / 2
    assert got["all-gather"] == local / 2
    assert got["all-reduce"] == 14 * act + 3 * 128 * 4
    assert got["_count"] == 43


def test_collectives_multipod_fsdp_and_decode_combine():
    """The same cell with FSDP on a pod x data x model mesh: each leaf FSDP
    shards is gathered twice and reduce-scattered over 'data', its
    gradient all-reduced over 'pod'; a decode step whose cache shards its
    sequence (2 kv heads over a 4-wide model axis) combines over it."""
    cfg = get_config("qwen3_1_7b").smoke()
    sizes = {"pod": 2, "data": 2, "model": 2}
    args = dryrun.cell_args(cfg, SMALL, sizes, fsdp=True)
    got = dryrun.collective_plan(cfg, SMALL, sizes, args)
    assert got["per_op_counts"]["all-gather"] == 2 * 13
    assert got["per_op_counts"]["reduce-scatter"] == 13
    assert got["per_op_counts"]["all-reduce"] == 13 + 2 + 12 + 3

    dcfg = cfg.with_(n_kv_heads=2)
    shape = ShapeSpec("d", 64, 8, "decode")
    sizes = {"data": 2, "model": 4}
    args = dryrun.cell_args(dcfg, shape, sizes)
    assert args["cache"]["k"].spec[2] == "model"
    got = dryrun.collective_plan(dcfg, shape, sizes, args)
    # the cache's sequence is sharded over 'model', so every rank combines
    # all 4 query heads
    layers, b, hq, dh = 2, 4, dcfg.n_heads, dcfg.head_dim
    # forward all-reduces of wo and w_down, the embedding's, and the
    # combine's max, sum and output for each layer
    assert got["per_op_counts"]["all-reduce"] == 2 * layers + 1 + 3 * layers
    act = 2 * (b * 128 * 4) * 3 / 4
    combine = 2 * (2 * b * hq * 4 + b * hq * dh * 4) * 3 / 4
    assert got["all-reduce"] == pytest.approx(
        (2 * layers + 1) * act + layers * combine)


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_1_2b",
                                  "deepseek_v2_lite"])
def test_composed_cost_equals_full_trace(arch):
    """The composed decomposition (first + (L-1) x layer delta, the hybrid's
    shared block a term of its own) against the full-depth trace."""
    cfg = get_config(arch).smoke()
    # the hybrid: 7 layers, its shared block after layers 3 and 6
    cfg = cfg.with_(n_layers=7, attn_every=3) if cfg.attn_every \
        else cfg.with_(n_layers=4)
    shape = ShapeSpec("t", 16, 2, "train")
    full = dryrun.trace_step(cfg, shape)
    comp = dryrun.composed_trace(cfg, shape)
    assert comp.flops == full.flops
    assert comp.bytes_accessed == full.bytes_accessed
    assert comp.ops == full.ops


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_500k_skipped_for_full_attention(arch):
    cfg = get_config(arch)
    r = dryrun.plan_cell(cfg, SHAPES["long_500k"], {"data": 16, "model": 16})
    if cfg.sub_quadratic:
        assert "skipped" not in r and r["flops_per_device"] > 0
    else:
        assert set(r) == {"skipped"} and "long_500k" in r["skipped"]


def test_trace_counts_train_step_and_moe_route():
    """A training trace counts remat's second forward (useful FLOPs below
    1), and the MoE's data-dependent bincount goes through its static
    route."""
    cfg = get_config("deepseek_v2_lite").smoke()
    r = dryrun.plan_cell(cfg, SMALL, {"data": 1, "model": 1})
    assert r["memory"]["temp_bytes"] > 0
    assert 0 < r["useful_flops_ratio"] < 1
    assert r["collectives"]["_count"] == 0
    n, b, s = cfg.active_param_count(), SMALL.global_batch, SMALL.seq_len
    assert r["model_flops_global"] == 6 * n * b * s
