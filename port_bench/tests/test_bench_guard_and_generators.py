"""The guard against the JAX package, and the frozen generator copies
against the program's originals."""

import ast
import sys
import types

import numpy as np
import pytest

from port_bench import generators, harness


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "repro",
                                  "repro.core", "jax.numpy"])
def test_guard_fails_a_run_that_loaded(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name in harness.forbidden_loaded()


def test_guard_passes_the_port(monkeypatch):
    for name in ["jax", "jaxlib", "flax"] + [
            m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name, raising=False)
    harness.program_path()
    import repro_torch.core  # noqa: F401
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert harness.forbidden_loaded() == []


def _imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    as ``.``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_reference_imports_no_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "numpy", "."}, path.name


def test_bench_imports_no_jax_and_reads_no_old_benchmark():
    for path in harness.HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path.name
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for bad in ("BENCH_dbbench", "benchmarks/", "scripts/"):
            assert bad not in text, (path.name, bad)
        assert "chip_smoke" not in _imports(path), path.name


def test_load_and_zipf_equal_the_program():
    harness.program_path()
    from repro_torch.bench_kv import workloads
    seed = 2 ** 31 + 17
    assert np.array_equal(generators.load_keys(5000, seed),
                          workloads.load_keys(5000, seed))
    pop = np.unique(workloads.load_keys(3000, seed))
    assert np.array_equal(generators.zipf_keys(pop, 4000, seed=seed),
                          workloads.zipf_keys(pop, 4000, seed=seed))
    for frac in (0.5, 0.95):
        want = workloads._mixed("run", pop, 4000, frac, "zipfian", seed)
        kinds, keys = generators._mixed(pop, 4000, frac, seed)
        assert np.array_equal(kinds, want.op_types)
        assert np.array_equal(keys, want.keys)
        kinds, idx = generators.mixed_index(pop.shape[0], 4000, frac, seed)
        assert np.array_equal(pop[idx], want.keys)


def test_trace_equals_chip_smoke():
    sys.path.insert(0, str(harness.ROOT))
    harness.program_path()
    import chip_smoke
    want = chip_smoke.ycsb_trace(np, 6000, 3000, seed=2 ** 31 + 1)
    got = generators.ycsb_trace(6000, 3000, seed=2 ** 31 + 1)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))
