"""The port's DES schedule sanitizer (``repro_torch.analysis.sanitizer``,
``REPRO_SANITIZE=1``) against the reference's ``repro.analysis.sanitizer``.

Rules S401-S404 are driven with the same hook sequences on both sides and
must raise the same rule at the same call; the env gate must agree.  Runs of
the port's ``Simulator`` and ``FleetEngine`` under ``REPRO_SANITIZE=1`` must
check events and jobs, raise nothing and equal the runs without it exactly
(latencies bit for bit: the hooks only read).
"""

import numpy as np
import pytest

from repro.analysis import sanitizer as ref_san
from repro.bench_kv.workloads import load_keys, make_run_a
from repro_torch.analysis import sanitizer as san
from repro_torch.core import DeviceModel, FleetEngine, Simulator, policies
from repro_torch.core.uids import reset_uid_counters as port_reset

SCALE = 1 << 16
LAM = SCALE / (64 << 20)
POLICIES = ("vlsm", "rocksdb", "rocksdb_io", "adoc", "lsmi", "lazy")


class _Job:
    """The job fields the sanitizer reads."""

    def __init__(self, t_start, t_finish, level=1, kind="compact",
                 parent=None, chain_id=0):
        self.t_start, self.t_finish = t_start, t_finish
        self.level, self.kind = level, kind
        self.parent_job, self.chain_id = parent, chain_id
        self.scheduled = True


def _s402_unscheduled(mod):
    s = mod.ScheduleSanitizer()
    parent = _Job(0.0, 1.0)
    parent.scheduled = False
    s.on_schedule(0, _Job(2.0, 3.0, level=2, parent=parent))


def _s402_early(mod):
    s = mod.ScheduleSanitizer()
    parent = _Job(0.0, 1.0)
    s.on_schedule(0, parent)
    s.on_schedule(0, _Job(0.5, 2.0, level=2, parent=parent))


def _s403(mod):
    s = mod.ScheduleSanitizer()
    s.on_schedule(3, _Job(0.0, 1.0, level=1))
    s.on_schedule(4, _Job(0.5, 1.5, level=1))      # another tree: fine
    s.on_schedule(3, _Job(0.5, 2.0, level=1))


def _s401(mod):
    s = mod.ScheduleSanitizer()
    s.on_event(0, 1.0)
    s.on_event(1, 0.5)                              # another tree: fine
    s.on_event(0, 1.0 - 0.5 * mod.EPS)              # within the slack
    s.on_event(0, 0.9)


def _s404(mod):
    s = mod.ScheduleSanitizer()
    s.on_gate(2, 5.0)
    s.on_gate(2, 5.0)
    s.on_gate(2, 4.0)


@pytest.mark.parametrize("case,rule", [(_s401, "S401"),
                                       (_s402_unscheduled, "S402"),
                                       (_s402_early, "S402"), (_s403, "S403"),
                                       (_s404, "S404")])
def test_each_rule_raises_as_reference(case, rule):
    with pytest.raises(san.ScheduleSanitizerError, match=rule) as got:
        case(san)
    with pytest.raises(ref_san.ScheduleSanitizerError, match=rule) as want:
        case(ref_san)
    assert str(got.value) == str(want.value)
    assert issubclass(san.ScheduleSanitizerError, AssertionError)


def test_clean_sequence_and_reset():
    s = san.ScheduleSanitizer()
    parent = _Job(0.0, 1.0)
    s.on_schedule(0, parent)
    s.on_schedule(0, _Job(1.0, 2.0, level=2, parent=parent))
    s.on_schedule(0, _Job(1.0, 2.0, level=1))       # slot free at 1.0
    s.on_event(0, 2.0)
    s.on_gate(0, 2.0)
    assert (s.events_checked, s.jobs_checked) == (1, 3)
    s.reset()
    s.on_event(0, 0.0)                              # a new timeline
    s.on_gate(0, 0.0)
    assert (s.events_checked, s.jobs_checked) == (1, 0)


@pytest.mark.parametrize("value,on", [(None, False), ("", False),
                                      ("0", False), ("1", True),
                                      ("yes", True)])
def test_env_gate_as_reference(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv(san.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(san.ENV_VAR, value)
    assert san.ENV_VAR == ref_san.ENV_VAR == "REPRO_SANITIZE"
    got, want = san.maybe_sanitizer(), ref_san.maybe_sanitizer()
    assert (got is not None) == (want is not None) == on
    if on:
        assert isinstance(got, san.ScheduleSanitizer)


def _trace():
    pop = np.unique(load_keys(6_000, seed=7))
    spec = make_run_a(pop, 4_000, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    load = np.arange(pop.shape[0], dtype=np.float64) / 1e6
    arrivals = np.concatenate([load, load[-1] + 0.5 + np.arange(
        spec.op_types.shape[0], dtype=np.float64) / 20_000.0])
    return ops, keys, arrivals


@pytest.mark.parametrize("engine_cls", (Simulator, FleetEngine),
                         ids=("serial", "fleet"))
@pytest.mark.parametrize("policy", POLICIES)
def test_sanitized_runs_equal_plain_runs(monkeypatch, policy, engine_cls):
    ops, keys, arrivals = _trace()
    cfg = policies.get(policy).default_config(SCALE).with_(n_shards=2)
    out = {}
    for value in ("0", "1"):
        monkeypatch.setenv("REPRO_SANITIZE", value)
        port_reset()
        eng = engine_cls(cfg, DeviceModel.scaled(LAM), compute_device="cpu")
        out[value] = (eng, eng.run(ops, keys, arrivals))
    (plain, r_plain), (checked, r_checked) = out["0"], out["1"]
    assert plain.sanitizer is None
    assert checked.sanitizer.events_checked > 0
    assert checked.sanitizer.jobs_checked == len(r_checked.job_log) > 0
    np.testing.assert_array_equal(r_checked.latency, r_plain.latency)
    assert r_checked.stall_events == r_plain.stall_events
    assert [(j.uid, j.t_start, j.t_finish) for j in r_checked.job_log] == \
        [(j.uid, j.t_start, j.t_finish) for j in r_plain.job_log]
