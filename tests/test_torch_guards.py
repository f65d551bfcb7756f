"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package, and its entry points run on the card unless the CPU is asked for."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench_kv.workloads import WorkloadSpec
from repro_torch.bench_kv.ycsb import run_ycsb
from repro_torch.configs import get_config
from repro_torch.core import LSMTree, Simulator, get_policy
from repro_torch.launch import serve
from repro_torch.models import forward, init_model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_covers_the_slice():
    assert len(PORT_FILES) > 20
    assert {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob(
        "*.cu")} == {"merge_path.cu", "overlap_scan.cu", "lindley_scan.cu",
                     "flash_attention.cu", "flash_attention_bwd.cu",
                     "ssd_scan.cu", "ssd_scan_bwd.cu", "paged_attention.cu"}


def test_entry_points_default_to_cuda():
    cfg = get_policy("vlsm").default_config(1 << 16)
    spec = WorkloadSpec("tiny", np.zeros(10, np.uint8),
                        np.arange(10, dtype=np.int64))
    if torch.cuda.is_available():
        assert Simulator(cfg).compute_device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        Simulator(cfg)
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        LSMTree(cfg)
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        run_ycsb(cfg, spec, rate=1e3)
    res = run_ycsb(cfg, spec, rate=1e3, compute_device="cpu")
    assert res.sim.latency.shape == (10,)


def test_lm_entry_points_default_to_cuda():
    mcfg = get_config("mamba2_130m").smoke().with_(n_layers=1)
    if torch.cuda.is_available():
        assert init_model(mcfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        init_model(mcfg)
    params = init_model(mcfg, compute_device="cpu")
    batch = {"tokens": np.zeros((1, 4), np.int32)}
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        forward(mcfg, params, batch)
    logits, _ = forward(mcfg, params, batch, compute_device="cpu")
    assert logits.shape == (1, 1, mcfg.vocab_size)
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        serve.run("mamba2_130m", n_requests=1, decode_tokens=1)
    out = serve.run("mamba2_130m", n_requests=1, decode_tokens=1,
                    compute_device="cpu")
    assert len(out["outputs"]) == 1


def test_library_path_sees_the_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source and of every
    ``csrc/*.cuh``: editing a shared header, adding one or editing the
    source names another library (a stale one is never loaded)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "wgmma.cuh"\n')
    (tmp_path / "wgmma.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "wgmma.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// new\n")
    third = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "wgmma.cuh"\n// edited\n')
    fourth = _build.library_path("k")
    assert len({first, second, third, fourth}) == 4
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
