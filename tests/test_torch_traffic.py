"""The port's open-loop traffic and admission layer (``repro_torch.serving``,
``Simulator.serve``, ``serve_grid``) against the JAX package's reference on
the CPU (``compute_device="cpu"``), at the reference's test sizes
(``tests/test_traffic.py``: scale 1 << 17, ``DeviceModel.scaled(1/1024)``,
3,000 keys preloaded, 1.2 s of offered traffic).

Tolerances: generated arrays (``materialize``, ``bursty_arrivals``) and
admission verdicts must be equal bit for bit; stall events, per-op reads and
the tenant ledgers exactly; latencies within 1e-9 s, the reference's own
engine-parity tolerance (``tests/test_sim.py``).  The reference runs on its
numpy tiers (``tests/_torch_parity.py``) and through its serial engine, as
its ``FleetEngine.run`` defaults to a jnp tier that does not run on JAX
0.9.0; both sides rewind their uid counters before every run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DeviceModel as RefDeviceModel
from repro.core import Simulator as RefSimulator
from repro.core import get_policy as ref_policy
from repro.core.fleet import reset_uid_counters as ref_reset
from repro.serving import AdmissionConfig as RefAdmissionConfig
from repro.serving import TenantSpec as RefTenantSpec
from repro.serving import TrafficSpec as RefTrafficSpec
from repro.serving import admit as ref_admit
from repro.serving import bursty_arrivals as ref_bursty
from repro.serving import materialize as ref_materialize
from repro.serving import serve_grid as ref_serve_grid
from repro_torch.core import DeviceModel, FleetEngine, Simulator, get_policy
from repro_torch.core.shard import ShardRouter
from repro_torch.core.uids import reset_uid_counters as port_reset
from repro_torch.serving import (ADMIT, SHED, THROTTLE, AdmissionConfig,
                                 TenantSpec, TrafficSpec, admit,
                                 bursty_arrivals, materialize, serve_grid)
from _torch_parity import reference_numpy_tiers  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_numpy_tiers")

SCALE = 1 << 17
LAM = 1 / 1024
POLICIES = ("vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi", "lazy")
STREAM_FIELDS = ("op_types", "keys", "arrivals", "scan_lens", "tenant_ids",
                 "tenant_seq")
LATENCY_TOL_S = 1e-9


def _one_tenant_spec(ns, arrival="deterministic", admission=None, seed=11):
    return ns["TrafficSpec"](
        tenants=(ns["TenantSpec"]("t0", rate_ops_s=3_000.0, mix="ycsb_a",
                                  arrival=arrival, priority=1,
                                  slo_ms=50.0),),
        duration_s=1.2, population=3_000, seed=seed, settle_s=5.0,
        admission=admission)


def _shedding_spec(ns, seed=11, admission=True):
    """Three tenants hot enough to trip both throttling and shedding (the
    reference's ``tests/test_traffic.py::_shedding_spec``)."""
    T = ns["TenantSpec"]
    return ns["TrafficSpec"](
        tenants=(
            T("prio", rate_ops_s=400.0, mix="ycsb_b", arrival="poisson",
              priority=0, slo_ms=25.0),
            T("mid", rate_ops_s=1_500.0, mix="ycsb_a", arrival="bursty",
              priority=1, slo_ms=50.0, limit_ops_s=1_200.0, burst_ops=32.0),
            T("bulk", rate_ops_s=2_500.0, mix="load", arrival="poisson",
              priority=2, slo_ms=200.0),
        ),
        duration_s=1.2, population=3_000, seed=seed, settle_s=5.0,
        admission=ns["AdmissionConfig"](max_queue_delay_s=0.02)
        if admission else None)


PORT = {"TrafficSpec": TrafficSpec, "TenantSpec": TenantSpec,
        "AdmissionConfig": AdmissionConfig}
REF = {"TrafficSpec": RefTrafficSpec, "TenantSpec": RefTenantSpec,
       "AdmissionConfig": RefAdmissionConfig}


def _cfg(policy: str, shards: int = 2):
    return get_policy(policy).default_config(scale=SCALE).with_(
        n_shards=shards)


def _ref_cfg(policy: str, shards: int = 2):
    return ref_policy(policy).default_config(scale=SCALE).with_(
        n_shards=shards)


def _chain_ledger(engine):
    """The per-shard chain ledger, as comparable tuples."""
    return [[(c.chain_id, c.trigger, c.length, c.width, c.width_bytes,
              c.n_jobs, round(c.t_start, 12), round(c.t_finish, 12),
              round(c.stall_s, 12)) for c in st.chains]
            for st in engine.shard_stats]


def _same_serve(got, want) -> None:
    """A port ``ServeResult`` against another (or the reference's)."""
    np.testing.assert_array_equal(got.verdicts, want.verdicts)
    assert got.res.stall_events == want.res.stall_events
    np.testing.assert_array_equal(got.res.get_reads, want.res.get_reads)
    np.testing.assert_array_equal(got.res.get_probed, want.res.get_probed)
    assert float(np.max(np.abs(got.res.latency - want.res.latency))) \
        < LATENCY_TOL_S
    assert [dataclasses.asdict(t) for t in got.tenants] == \
        [dataclasses.asdict(t) for t in want.tenants]
    assert got.duration_s == want.duration_s


# ------------------------------------------------------- generators

@pytest.mark.parametrize("seed", [3, 11, 29])
def test_materialize_equals_reference(seed):
    for admission in (False, True):
        for factor in (1.0, 2.5):
            got = materialize(_shedding_spec(PORT, seed, admission), factor)
            want = ref_materialize(_shedding_spec(REF, seed, admission),
                                   factor)
            for f in STREAM_FIELDS:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            assert (got.n_load, got.t_run_start_s, got.duration_s,
                    got.load_factor, got.n_offered) == \
                (want.n_load, want.t_run_start_s, want.duration_s,
                 want.load_factor, want.n_offered)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bursty_arrivals_equal_reference(seed):
    for n, sources in ((1, 1), (5_000, 4), (20_000, 7)):
        got = bursty_arrivals(n, 2_000.0, np.random.default_rng(seed),
                              n_sources=sources, on_s=0.1, off_s=0.5)
        want = ref_bursty(n, 2_000.0, np.random.default_rng(seed),
                          n_sources=sources, on_s=0.1, off_s=0.5)
        assert got.shape == (n,)
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))


@pytest.mark.parametrize("seed", [5, 11, 23])
def test_admit_verdicts_equal_reference(seed):
    spec, ref_spec = _shedding_spec(PORT, seed), _shedding_spec(REF, seed)
    cfg, ref_cfg = _cfg("vlsm"), _ref_cfg("vlsm")
    dev, ref_dev = DeviceModel.scaled(LAM), RefDeviceModel.scaled(LAM)
    for factor in (1.0, 3.0):
        st = materialize(spec, factor)
        shard_ids = ShardRouter.from_config(cfg).shard_of(st.keys)
        got = admit(st.op_types, st.arrivals, st.tenant_ids, shard_ids,
                    spec.tenants, spec.admission, cfg, dev)
        want = ref_admit(st.op_types, st.arrivals, st.tenant_ids, shard_ids,
                         ref_spec.tenants, ref_spec.admission, ref_cfg,
                         ref_dev)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got[st.tenant_ids < 0] == ADMIT).all()
        assert (got == SHED).any() and (got == THROTTLE).any()


# ------------------------------------------- parity within the port

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("engine_cls", (Simulator, FleetEngine),
                         ids=("serial", "fleet"))
def test_closed_open_parity(policy, engine_cls):
    """Admission disabled: ``serve`` equals ``run`` on the materialized
    arrays — latencies bit for bit, stall events, reads and the chain
    ledger — and every offered op is admitted."""
    spec = _one_tenant_spec(PORT)
    stream = materialize(spec)
    port_reset()
    closed = engine_cls(_cfg(policy), DeviceModel.scaled(LAM),
                        compute_device="cpu")
    r_closed = closed.run(stream.op_types, stream.keys, stream.arrivals,
                          stream.scan_lens)
    port_reset()
    open_ = engine_cls(_cfg(policy), DeviceModel.scaled(LAM),
                       compute_device="cpu")
    sr = open_.serve(spec)
    np.testing.assert_array_equal(sr.res.latency, r_closed.latency)
    assert sr.res.stall_events == r_closed.stall_events
    np.testing.assert_array_equal(sr.res.get_reads, r_closed.get_reads)
    assert _chain_ledger(open_) == _chain_ledger(closed)
    (led,) = sr.tenants
    assert led.ops_offered == led.ops_admitted == stream.n_offered
    assert led.ops_shed == led.ops_throttled == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_matches_serial_under_shedding(policy):
    """Admission on: both engines receive the same admitted stream
    (verdicts equal) and agree on it within 1e-9 s."""
    spec = _shedding_spec(PORT)
    port_reset()
    ser = Simulator(_cfg(policy), DeviceModel.scaled(LAM),
                    compute_device="cpu").serve(spec)
    port_reset()
    fle = FleetEngine(_cfg(policy), DeviceModel.scaled(LAM),
                      compute_device="cpu").serve(spec)
    _same_serve(fle, ser)
    assert ser.shed_frac > 0.0 and ser.throttled_frac > 0.0


# -------------------------------------------- port against reference

@pytest.mark.parametrize("admission", [False, True], ids=("off", "on"))
@pytest.mark.parametrize("policy", POLICIES)
def test_serve_equals_reference(policy, admission):
    """``Simulator.serve`` on both sides: verdicts, ledgers, stall events
    and reads equal, latency within 1e-9 s, chain ledgers equal."""
    ref_reset()
    ref_sim = RefSimulator(_ref_cfg(policy), RefDeviceModel.scaled(LAM))
    want = ref_sim.serve(_shedding_spec(REF, admission=admission),
                         load_factor=1.5)
    port_reset()
    sim = Simulator(_cfg(policy), DeviceModel.scaled(LAM),
                    compute_device="cpu")
    got = sim.serve(_shedding_spec(PORT, admission=admission),
                    load_factor=1.5)
    _same_serve(got, want)
    assert _chain_ledger(sim) == _chain_ledger(ref_sim)
    for prop in ("offered_ops", "shed_frac", "throttled_frac",
                 "slo_violation_frac", "goodput_ops_s", "offered_ops_s"):
        assert getattr(got, prop) == getattr(want, prop), prop
    np.testing.assert_array_equal(np.isnan(got.latency_full),
                                  np.isnan(want.latency_full))
    assert (got.shed_frac > 0) == admission


def test_admission_counters_land_in_stats_as_reference():
    """Per-(tenant, shard) ledgers and the scalar admission counters in
    every shard's Stats equal the reference's."""
    ref_reset()
    ref_sim = RefSimulator(_ref_cfg("vlsm"), RefDeviceModel.scaled(LAM))
    ref_sim.serve(_shedding_spec(REF))
    port_reset()
    sim = Simulator(_cfg("vlsm"), DeviceModel.scaled(LAM),
                    compute_device="cpu")
    sr = sim.serve(_shedding_spec(PORT))
    for st, ref_st in zip(sim.shard_stats, ref_sim.shard_stats, strict=True):
        assert (st.ops_offered, st.ops_shed, st.ops_throttled,
                st.slo_violations) == (ref_st.ops_offered, ref_st.ops_shed,
                                       ref_st.ops_throttled,
                                       ref_st.slo_violations)
        assert {k: dataclasses.asdict(v) for k, v in st.tenants.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref_st.tenants.items()}
        assert st.summary() == ref_st.summary()
    assert sum(st.ops_offered for st in sim.shard_stats) == sr.offered_ops
    # conservation, per tenant and over the verdicts
    for led in sr.tenants:
        assert led.ops_admitted + led.ops_shed + led.ops_throttled \
            == led.ops_offered
    n_verdicts = np.bincount(sr.verdicts[sr.stream.tenant_ids >= 0],
                             minlength=3)
    assert n_verdicts.sum() == sr.offered_ops
    assert sr.res.latency.shape[0] == int((sr.verdicts == ADMIT).sum())
    assert sr.tenants[0].ops_shed == 0


@pytest.mark.parametrize("admission", [False, True], ids=("off", "on"))
def test_serve_grid_matches_per_factor_serve_and_reference(admission):
    """The port's ``serve_grid`` equals fresh per-factor ``serve`` calls
    (admission off: one structural replay, one temporal pass per factor)
    and the reference's ``serve_grid``."""
    factors = (0.5, 2.0)
    cfg = _cfg("vlsm")
    spec = _shedding_spec(PORT, admission=admission)
    grid = serve_grid(cfg, DeviceModel.scaled(LAM), spec, factors,
                      compute_device="cpu")
    want = ref_serve_grid(_ref_cfg("vlsm"), RefDeviceModel.scaled(LAM),
                          _shedding_spec(REF, admission=admission), factors)
    for f, sr_grid, sr_ref in zip(factors, grid, want, strict=True):
        port_reset()
        sr = Simulator(cfg, DeviceModel.scaled(LAM),
                       compute_device="cpu").serve(spec, load_factor=f)
        _same_serve(sr_grid, sr)
        _same_serve(sr_grid, sr_ref)
        assert set(sr_grid.timing) == set(sr_ref.timing)
        assert sr_grid.stream.load_factor == f


def test_serve_grid_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        return
    spec = _one_tenant_spec(PORT)
    with pytest.raises(RuntimeError, match="compute_device='cpu'"):
        serve_grid(_cfg("vlsm"), DeviceModel.scaled(LAM), spec, (1.0,))


def test_admission_prevents_collapse_past_knee():
    """db_bench's pinned serve_sweep spec past the knee (factor 3.0): the
    open loop busts the priority-0 SLO, admission sheds low-priority work
    and keeps the priority-0 tail bounded — and both runs equal the
    reference's."""
    from repro.bench_kv.db_bench import make_serve_spec as ref_spec
    from repro_torch.bench_kv.db_bench import make_serve_spec
    scale = 1 << 18
    lam = scale / (64 << 20)
    cfg = get_policy("vlsm").default_config(scale=scale).with_(n_shards=2)
    ref_cfg = ref_policy("vlsm").default_config(scale=scale).with_(
        n_shards=2)
    out = {}
    for adm in (False, True):
        spec = make_serve_spec(duration_s=1.5, population=3_000,
                               admission=adm)
        port_reset()
        out[adm] = Simulator(cfg, DeviceModel.scaled(lam),
                             compute_device="cpu").serve(spec,
                                                         load_factor=3.0)
        ref_reset()
        want = RefSimulator(ref_cfg, RefDeviceModel.scaled(lam)).serve(
            ref_spec(duration_s=1.5, population=3_000, admission=adm),
            load_factor=3.0)
        _same_serve(out[adm], want)
    off, on = out[False], out[True]
    p999_off = float(np.percentile(off.tenant_latency(0), 99.9)) * 1e3
    p999_on = float(np.percentile(on.tenant_latency(0), 99.9)) * 1e3
    assert off.shed_frac == 0.0
    assert p999_off > 2 * off.tenants[0].slo_ms
    assert off.tenants[0].slo_violation_frac > 0.2
    assert on.shed_frac > 0.1
    assert on.tenants[0].ops_shed == 0
    assert p999_on < p999_off / 2
    assert on.tenants[0].slo_violation_frac < 0.05
    assert on.goodput_ops_s > 0.5 * off.goodput_ops_s


def test_interleave_preserves_order():
    stream = materialize(_shedding_spec(PORT))
    assert np.all(np.diff(stream.arrivals) >= 0)
    for ti in np.unique(stream.tenant_ids[stream.tenant_ids >= 0]):
        assert np.all(np.diff(stream.tenant_seq[stream.tenant_ids == ti])
                      == 1)
