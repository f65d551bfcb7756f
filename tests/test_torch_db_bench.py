"""The port's db_bench store benches against the JAX package's reference on
the CPU (``compute_device="cpu"``), at reduced op counts, for every
registered policy.

Rows must be equal once the keys a run may change are dropped: the timing
and machine keys ``scripts/check_row_parity.py`` drops, and the two keys
that name a tier (``index_backend``, the fleet summary's ``backend``),
which carry the port's compute device.  The reference runs on its numpy
tiers (``tests/_torch_parity.py``; its fleet Lindley with
``backend="numpy"``), and both sides rewind their uid counters before every
bench, because uids seed the bloom model.
"""

import json

import pytest
import torch

from repro.bench_kv import db_bench as ref_bench
from repro.core import policies as ref_policies
from repro.core.fleet import reset_uid_counters as ref_reset
from repro_torch.bench_kv import db_bench
from repro_torch.core import policies
from repro_torch.core.uids import reset_uid_counters as port_reset
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 16
POLICIES = ["vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi", "lazy"]
VOLATILE = frozenset({
    "wall_clock_s", "fleet_wall_s", "serial_wall_s", "speedup",
    "structural_s", "temporal_s", "lindley_s", "finalize_s", "cache_hit",
    "executor_wall_s", "serial_equiv_s", "cache_hits", "cache_misses",
    "tasks", "workers", "index_backend", "backend"})


def _strip(row):
    if isinstance(row, dict):
        return {k: _strip(v) for k, v in row.items() if k not in VOLATILE}
    if isinstance(row, list):
        return [_strip(v) for v in row]
    return row


def _both(name: str, bench, *args, shards: int = 1, router: str = "hash",
          **kw):
    """The same bench on both sides, each from rewound uid counters."""
    ref_cfg = ref_policies.get(name).default_config(SCALE).with_(
        n_shards=shards, shard_router=router)
    cfg = policies.get(name).default_config(SCALE).with_(
        n_shards=shards, shard_router=router)
    ref_reset()
    want = getattr(ref_bench, bench)(ref_cfg, *args, scale=SCALE, **kw)
    port_reset()
    got = getattr(db_bench, bench)(cfg, *args, scale=SCALE,
                                   compute_device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("name", POLICIES)
def test_fillrandom_and_chain_report_rows(name):
    for dist in ("uniform", "pareto"):
        ref_cfg = ref_policies.get(name).default_config(SCALE)
        cfg = policies.get(name).default_config(SCALE)
        ref_reset()
        ref_run = ref_bench.fill_sim(ref_cfg, 8_000, dist, SCALE)
        port_reset()
        run = db_bench.fill_sim(cfg, 8_000, dist, SCALE,
                                compute_device="cpu")
        got = db_bench.fillrandom(cfg, 8_000, dist=dist, scale=SCALE, run=run)
        want = ref_bench.fillrandom(ref_cfg, 8_000, dist=dist, scale=SCALE,
                                    run=ref_run)
        assert _strip(got) == _strip(want)
        assert got["compactions"] > 0
        got = db_bench.chain_report(cfg, 8_000, dist=dist, scale=SCALE,
                                    run=run)
        want = ref_bench.chain_report(ref_cfg, 8_000, dist=dist,
                                      scale=SCALE, run=ref_run)
        assert _strip(got) == _strip(want)


@pytest.mark.parametrize("name", POLICIES)
def test_read_path_rows(name):
    got, want = _both(name, "read_path", 3_000, 4_000)
    assert _strip(got) == _strip(want)
    assert got["device_reads"] > 0 and got["index_backend"] == "cpu"


@pytest.mark.parametrize("name", POLICIES)
def test_ycsb_a_rows(name):
    got, want = _both(name, "ycsb_a", 3_000, 4_000, rate=6_000.0)
    assert _strip(got) == _strip(want)


@pytest.mark.parametrize("name", POLICIES)
def test_seekrandom_rows(name):
    got, want = _both(name, "seekrandom", 120, 3_000)
    assert _strip(got) == _strip(want)
    assert got["scan_files_per_op"] > 0


@pytest.mark.parametrize("name", POLICIES)
def test_shard_sweep_rows(name):
    stalled = 0
    for k in db_bench.SHARD_COUNTS:
        got, want = _both(name, "shard_sweep", 4_000, 4_000, shards=k,
                          rate=db_bench.SWEEP_RATE)
        assert _strip(got) == _strip(want)
        stalled += got["n_stalls"]
    if name == "vlsm":
        assert stalled, "vlsm x1 stalls at this size, as at full size"
    got, want = _both(name, "shard_sweep", 4_000, 4_000,
                      shards=db_bench.HOT_SHARDS, router="range",
                      dist="zipf_ranked", rate=db_bench.HOT_RATE)
    assert _strip(got) == _strip(want)
    assert len(got["per_shard"]) == db_bench.HOT_SHARDS


def test_fleet_sweep_rows():
    rates = (5_000.0, 40_000.0)
    want = ref_bench.fleet_sweep_bench(POLICIES, 4_000, 4_000, scale=SCALE,
                                       rates=rates, shard_counts=(1, 4),
                                       backend="numpy")
    got = db_bench.fleet_sweep_bench(POLICIES, 4_000, 4_000, scale=SCALE,
                                     rates=rates, shard_counts=(1, 4),
                                     compute_device="cpu")
    assert len(got) == len(want) == len(POLICIES) * 2 * len(rates) + 1
    assert _strip(got) == _strip(want)
    summary = got[-1]
    assert summary["parity_max_abs_latency_s"] <= 1e-9
    assert summary["parity_stalls_equal"] and summary["backend"] == "cpu"
    assert any(r["n_stalls"] for r in got[:-1])


def test_bench_constants_match_reference():
    for name in ("SHARD_COUNTS", "SWEEP_RATE", "FLEET_SHARD_COUNTS",
                 "FLEET_RATES", "FLEET_RATES_QUICK", "HOT_SHARDS",
                 "HOT_RATE"):
        assert getattr(db_bench, name) == getattr(ref_bench, name), name
    assert set(db_bench.BENCHES) | set(db_bench.NOT_PORTED) == \
        set(ref_bench.BENCHES)
    assert len(db_bench.FLEET_RATES) == 32


def test_main_rows_match_reference_main(tmp_path):
    """``main``'s wiring: quick shard and fleet sweeps for two policies,
    perf_trajectory row included, in the reference's row order."""
    argv = ["--quick", "--bench", "shard_sweep,fleet_sweep",
            "--policy", "vlsm,lazy"]
    ref_reset()
    ref_bench.main(argv + ["--json", str(tmp_path / "ref.json")])
    want = json.loads((tmp_path / "ref.json").read_text())
    port_reset()
    got = db_bench.main(argv + ["--compute-device", "cpu"])
    assert [r["bench"] for r in got] == [r["bench"] for r in want]
    assert got[-1]["bench"] == "perf_trajectory"
    assert _strip(got) == _strip(want)


def test_main_writes_no_file_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--quick", "--bench", "ycsb_a", "--policy", "lsmi",
            "--compute-device", "cpu"]
    port_reset()
    rows = db_bench.main(argv)
    assert [r["bench"] for r in rows] == ["ycsb_a"]
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "rows.json"
    port_reset()
    again = db_bench.main(argv + ["--json", str(out)])
    assert _strip(again) == _strip(rows)
    assert json.loads(out.read_text()) == again


def test_main_refuses_serve_sweep_and_unknown_names(capsys):
    for argv, msg in ((["--bench", "serve_sweep"], "not ported"),
                      (["--bench", "nope"], "unknown bench"),
                      (["--policy", "nope", "--compute-device", "cpu"],
                       "unknown policy")):
        with pytest.raises(SystemExit):
            db_bench.main(argv)
        assert msg in capsys.readouterr().err


def test_main_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert db_bench.resolve_compute_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        db_bench.main(["--quick", "--bench", "ycsb_a"])
