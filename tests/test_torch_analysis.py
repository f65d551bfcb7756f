"""The port's lint (``repro_torch.analysis``) against the reference's.

The port's rules run over the reference's fixture tree and over
``src/repro`` (``package="repro"``) and must give exactly the reference's
findings; over the port (the default package) they must find nothing,
with an empty baseline.  The schema family's runtime gate
(``REPRO_PARANOID_CHECKS=1``) is held on the port's own db_bench rows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis import catalog as ref_catalog
from repro.analysis.schemas import extract_variants as ref_extract_variants
from repro_torch.analysis import (DEFAULT_BASELINE_NAME, analyze_paths,
                                  analyze_repo, catalog, load_baseline,
                                  paranoid_validate_rows)
from repro_torch.analysis import schemas
from repro_torch.analysis.astutil import load_modules
from repro_torch.analysis.contracts import (check_contract_table,
                                            generate_contract_table)
from repro_torch.analysis.trees import TREES

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "lint_fixtures"
PORT_BASE_PY = ROOT / "src" / "repro_torch" / "core" / "policies" / "base.py"
PORT_DB_BENCH = "src/repro_torch/bench_kv/db_bench.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, env=_env())


def _key(f):
    """A finding as the parity compares it: the CLI name in hints is the
    one thing allowed to differ."""
    return (f.rule, f.family, f.path, f.line, f.message,
            f.hint.replace("repro_torch.", "repro."), f.snippet)


# ------------------------------------------------------ parity with the ref
def test_fixture_findings_equal_reference():
    want = sorted(map(_key, ref_analyze_paths(FIXTURES)))
    got = sorted(map(_key, analyze_paths(FIXTURES, package="repro")))
    assert len(want) == 22
    assert got == want


def test_reference_tree_findings_equal_reference():
    want = sorted(map(_key, ref_analyze_paths(ROOT)))
    got = sorted(map(_key, analyze_paths(ROOT, package="repro")))
    assert got == want


def test_rule_ids_and_families_equal_reference():
    assert {r.id: (r.family, r.runtime) for r in catalog.CATALOG.values()} \
        == {r.id: (r.family, r.runtime)
            for r in ref_catalog.CATALOG.values()}


@pytest.mark.parametrize("rule_id", sorted(catalog.CATALOG))
def test_explain_covers_every_rule(rule_id):
    text = catalog.explain(rule_id)
    assert text and rule_id in text
    res = _run_cli("--explain", rule_id)
    assert res.returncode == 0 and rule_id in res.stdout, res.stderr
    assert "python -m repro.analysis " not in catalog.CATALOG[rule_id].hint


def test_explain_unknown_rule_is_a_usage_error():
    res = _run_cli("--explain", "Z999")
    assert res.returncode == 2 and "Z999" in res.stderr


@pytest.mark.parametrize("family,rules", [
    ("layering", {"L101", "L102", "L103", "L104", "L105", "L106"}),
    ("determinism", {"D201", "D202", "D203", "D204", "D205"}),
    ("contracts", {"C301", "C302", "C303", "C304"}),
    ("units", {"U501", "U502", "U503", "U504"}),
    ("schemas", {"B601", "B602", "B603"}),
])
def test_each_family_fails_port_cli_on_fixture(family, rules):
    res = _run_cli("--package", "repro", "--root", str(FIXTURES),
                   "--rules", family, "--format", "json")
    assert res.returncode == 1, res.stderr
    report = json.loads(res.stdout)
    assert {f["rule"] for f in report["fresh"]} == rules


# --------------------------------------------------------------- the port
def test_port_cli_exits_zero_with_empty_baseline():
    assert load_baseline(ROOT / DEFAULT_BASELINE_NAME).fingerprints == set()
    data = json.loads((ROOT / DEFAULT_BASELINE_NAME).read_text())
    assert data["findings"] == []
    res = _run_cli()
    assert res.returncode == 0, res.stdout + res.stderr
    assert analyze_repo(apply_baseline=False) == []


def test_port_scope_covers_kernels_and_port_only_modules():
    """L105 reads the port's kernels/ (its _build.py and every ops.py
    wrapper), and the modules with no reference file are linted too."""
    tree = TREES["repro_torch"]
    mods = {m.rel: m for m in load_modules(ROOT, [ROOT / tree.src])}
    kernels = [r for r in mods if r.startswith(tree.kernels_dir)]
    assert f"{tree.kernels_dir}_build.py" in kernels
    assert sum(r.endswith("/ops.py") for r in kernels) == 6
    for rel in ("core/state.py", "models/state.py", "training/tree.py",
                "distributed/comm.py"):
        assert f"{tree.src}/{rel}" in mods
    assert {m.name for m in mods.values()} >= {"repro_torch.core.sim",
                                               "repro_torch.kernels._build"}


def test_port_contract_table_is_current():
    [mod] = load_modules(PORT_BASE_PY.parent, [PORT_BASE_PY])
    assert check_contract_table(mod) == []
    table = generate_contract_table(mod)
    assert "python -m repro_torch.analysis --write-contract-table" in table
    assert "merge_down" in table
    before = PORT_BASE_PY.read_text()
    res = _run_cli("--write-contract-table")
    assert res.returncode == 0, res.stderr
    assert PORT_BASE_PY.read_text() == before


def _schema_view(variants):
    return sorted((v.family, tuple(v.keys.items()),
                   tuple(sorted(v.optional.items())), v.open)
                  for v in variants)


def test_port_db_bench_schemas_equal_reference():
    """Family, keys (in order) and units of every db_bench variant; only
    the emitter's file and line differ."""
    ref = [v for v in ref_extract_variants(ROOT)
           if v.path.endswith("bench_kv/db_bench.py")]
    got = schemas.extract_variants(ROOT)
    assert {v.path for v in got} == {PORT_DB_BENCH}
    assert _schema_view(got) == _schema_view(ref)


def test_renamed_port_emitter_key_fires_b601_and_b602(tmp_path):
    for rel in (PORT_DB_BENCH, "docs/benchmarks.md", "BENCH_dbbench.json"):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((ROOT / rel).read_text())
    assert schemas.check(tmp_path) == []
    emitter = tmp_path / PORT_DB_BENCH
    src = emitter.read_text()
    assert '"p99_get_ms"' in src
    emitter.write_text(src.replace('"p99_get_ms"', '"p99_renamed_ms"'))
    findings = schemas.check(tmp_path)
    assert {f.rule for f in findings} >= {"B601", "B602"}, \
        [f.format() for f in findings]
    assert all(f.path in (PORT_DB_BENCH, "docs/benchmarks.md")
               for f in findings)


def test_paranoid_validate_rows_on_port_rows(monkeypatch):
    """Every family the port's db_bench emits at quick size passes the
    runtime gate inside ``main`` (seekrandom's family, ~30 s here, is held
    to the committed rows by B602); a renamed key fails it."""
    from repro_torch.bench_kv import db_bench
    monkeypatch.setenv("REPRO_PARANOID_CHECKS", "1")
    rows = db_bench.main([
        "--quick", "--compute-device", "cpu", "--policy", "vlsm",
        "--bench", "fillrandom,read_path,ycsb_a,chain_report,shard_sweep,"
                   "fleet_sweep,serve_sweep"])
    families = {r["bench"] for r in rows}
    assert families == {"fillrandom", "read_path", "ycsb_a", "chain_report",
                        "shard_sweep", "fleet_sweep", "serve_sweep",
                        "perf_trajectory"}
    paranoid_validate_rows(rows)
    fleet = next(r for r in rows if r["bench"] == "fleet_sweep"
                 and r.get("engine") == "fleet")
    bad = dict(fleet)
    bad["lindley_renamed_s"] = bad.pop("lindley_s")
    with pytest.raises(ValueError, match="fleet_sweep"):
        paranoid_validate_rows([bad])
    monkeypatch.delenv("REPRO_PARANOID_CHECKS")
    paranoid_validate_rows([bad])                # gated off
