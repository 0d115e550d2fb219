"""The port's fleet simulator (``bigdl_tpu_torch.sim``) against the JAX
package's, on the CPU.

- Every builtin chaos scenario at 20 hosts (seed 0, a 1 ms partition
  stall; the bundle plane armed for ``alert_storm`` in both packages):
  the same decisions (virtual time, direction, old and new world,
  reason), final world, transition and episode counts, sink failures,
  bundles, and invariant names and verdicts.  Wall-clock fields, and
  the details that print them, are left out.
- Every serve scenario: the same result dict but its wall time.
- The unit cases of ``tests/test_fleet_sim.py`` on the port: the
  virtual clock, the synthetic host's ``/healthz`` and ``/metrics``
  contract, loud scenario validation, and each invariant checker on
  hand-made inputs; and the ``python -m bigdl_tpu_torch.sim`` entry
  point at a small size, serially and in two worker processes (the
  same verdicts).
"""

import json
import logging

import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu import sim as jsim
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.obs import alerts as jalerts
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import sim as tsim
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.obs import alerts as talerts
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.metrics import parse_prometheus, sample_value
from bigdl_tpu_torch.sim import (BUILTIN_SCENARIOS, SERVE_SCENARIOS,
                                 SimFleet, VirtualClock, load_scenario)
from bigdl_tpu_torch.sim import invariants as inv

HOSTS, SEED, STALL = 20, 0, 0.001
_VARS = ("OBS", "TRACE_DIR", "METRICS_DIR", "OBS_PORT", "FLEET_HOSTS",
         "FLEET_SCENARIO", "FLEET_TIME_COMPRESSION", "FLEET_SEED",
         "ALERT_RULES", "ALERT_SINK", "BUNDLE_DIR", "BUNDLE_RATE_LIMIT",
         "REQTRACE_SAMPLE")


def _reset():
    for o, a in ((jobs, jalerts), (tobs, talerts)):
        o.reset()
        a.reset_engine()
    jreload()
    treload()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for v in _VARS:
        for pre in ("BIGDL_", "BIGDL_TORCH_"):
            monkeypatch.delenv(pre + v, raising=False)
    # the poisoned-sink scenario logs a warning per failed delivery
    for name in ("bigdl_tpu.obs", "bigdl_tpu_torch.obs"):
        monkeypatch.setattr(logging.getLogger(name), "level",
                            logging.ERROR)
    _reset()
    yield
    _reset()


# ---- the scenario matrix, both packages ------------------------------------------
def _comparable(res) -> dict:
    return {
        "name": res.name, "ok": res.ok, "hosts": res.hosts,
        "ticks": res.ticks, "duration_s": res.duration_s,
        "final_world": res.final_world,
        "decisions": [(d["t"], d["direction"], d["old_world"],
                       d["new_world"], d["reason"]) for d in res.decisions],
        "transitions": res.transitions, "episodes": res.episodes,
        "sink_failures": res.sink_failures, "bundles": res.bundles,
        "invariants": [(r.name, r.ok) for r in res.invariants],
    }


@pytest.mark.parametrize("name", list(BUILTIN_SCENARIOS))
def test_builtin_scenario_matches_jax(name, tmp_path, monkeypatch):
    assert set(BUILTIN_SCENARIOS) == set(jsim.BUILTIN_SCENARIOS)
    if name == "alert_storm":
        for pre in ("BIGDL_", "BIGDL_TORCH_"):
            monkeypatch.setenv(pre + "BUNDLE_DIR",
                               str(tmp_path / pre.lower()))
            monkeypatch.setenv(pre + "BUNDLE_RATE_LIMIT", "0")
    got = {}
    for key, pkg in (("jax", jsim), ("torch", tsim)):
        res = pkg.run_scenario(name, hosts=HOSTS, seed=SEED,
                               partition_stall_s=STALL)
        assert res.ok, res.summary()
        got[key] = _comparable(res)
    assert got["torch"] == got["jax"]
    if name == "alert_storm":
        assert got["torch"]["bundles"] == got["torch"]["episodes"] > 0
    if name in ("diurnal", "latency_wave", "stragglers", "preemptions"):
        assert got["torch"]["decisions"]


@pytest.mark.parametrize("name", list(SERVE_SCENARIOS))
def test_serve_scenario_matches_jax(name):
    assert set(SERVE_SCENARIOS) == set(jsim.SERVE_SCENARIOS)
    got = {}
    for key, pkg in (("jax", jsim), ("torch", tsim)):
        res = pkg.run_serve_scenario(name, seed=SEED)
        assert res.ok, res.summary()
        d = res.to_dict()
        del d["wall_s"]
        got[key] = d
    assert got["torch"] == got["jax"]
    assert got["torch"]["requests"] > 1000


# ---- the unit cases of tests/test_fleet_sim.py, on the port -------------------------
def test_virtual_clock():
    vc = VirtualClock(10.0)
    assert vc() == vc.now() == 10.0
    vc.advance(2.5)
    vc.sleep(1.0)
    assert vc.now() == 13.5
    with pytest.raises(ValueError, match="advances"):
        VirtualClock().advance(-1.0)


def _host(**kw):
    clock = VirtualClock()
    fleet = SimFleet(1, clock, jitter=0.0, **kw)
    return fleet.hosts[0], fleet, clock


def test_host_healthz_and_metrics_speak_the_real_contract():
    from bigdl_tpu_torch.obs.server import health_payload

    host, fleet, _ = _host()
    assert set(host.health()) == set(health_payload())
    host.queue_depth, host.goodput_ratio = 37.0, 0.75
    fleet.tick(1.0)
    parsed = parse_prometheus(host.metrics_text())
    assert sample_value(parsed, names.SERVE_QUEUE_DEPTH) == 37.0
    assert sample_value(parsed, names.GOODPUT_RATIO) == 0.75
    assert any(s["name"] == "bigdl_request_latency_seconds_bucket"
               and s["labels"].get("kind") == "e2e"
               for s in parsed["samples"])
    # the fetch router: partitioned times out, down refuses
    fleet.partition(0)
    with pytest.raises(TimeoutError):
        fleet.fetch("http://sim0:9000/healthz")
    assert fleet.health_fetch("http://sim0:9000/healthz") is None
    fleet.partition(0, on=False)
    host.up = False
    with pytest.raises(ConnectionRefusedError):
        fleet.fetch("http://sim0:9000/metrics")


def test_host_step_stamp_stall_and_restart():
    host, fleet, clock = _host()
    fleet.tick(5.0)
    clock.advance(5.0)
    fleet.tick(5.0)
    first = host.step()
    assert first and first >= 90 and host.health()["status"] == "ok"
    host.stalled = True
    clock.advance(30.0)
    fleet.tick(5.0)
    h = host.health()
    assert host.step() == first
    assert h["status"] == "stalled" and h["step_age_s"] >= 30.0
    host.up = False
    host.restart()
    assert host.attempt == 1 and host.step() is None


@pytest.mark.parametrize("raw,msg", [
    ({"duration_s": 10}, "missing a name"),
    ({"name": "x", "duration_s": 0}, "must be > 0"),
    ({"name": "x", "duration_s": 10,
      "events": [{"kind": "tornado"}]}, "unknown kind"),
    ({"name": "x", "duration_s": 10,
      "events": [{"kind": "preempt"}]}, "missing 'down_s'"),
    ({"name": "x", "duration_s": 10,
      "events": [{"kind": "stall", "at_s": 9, "until_s": 3}]},
     "at_s < until_s"),
    ({"name": "x", "duration_s": 10,
      "events": [{"kind": "stall", "hosts": {"pct": 10}}]}, "selector"),
    ({"name": "x", "duration_s": 10, "expect": {"max_decide": 1}},
     "unknown expect"),
    ({"name": "x", "duration_s": 10,
      "autoscale": {"queue_hi": 3}}, "unknown autoscale"),
    ("clear_skies", "unknown scenario"),
])
def test_scenario_validation_is_loud(raw, msg):
    with pytest.raises(ValueError, match=msg):
        load_scenario(raw, hosts=8)


def test_scenarios_bind_compress_and_select_as_jax(tmp_path):
    for name in BUILTIN_SCENARIOS:
        sc = load_scenario(name, hosts=16, seed=3)
        js = jsim.load_scenario(name, hosts=16, seed=3)
        assert [ev["_ids"] for ev in sc.events] == \
            [ev["_ids"] for ev in js.events]
        assert sc.n_ticks() == js.n_ticks() > 0
    sc = load_scenario("diurnal", hosts=8, time_compression=2.0)
    full = load_scenario("diurnal", hosts=8)
    assert sc.duration_s == full.duration_s / 2
    assert sc.tick_s == full.tick_s
    assert sc.autoscale["cooldown_s"] == full.autoscale["cooldown_s"] / 2
    assert sc.alert_rules[0]["for"] == full.alert_rules[0]["for"]
    wave = load_scenario({"name": "w", "duration_s": 100, "tick_s": 5,
                          "events": [{"kind": "traffic", "base": 10,
                                      "amplitude": 40, "period_s": 100}]},
                         hosts=4)
    assert wave.offered(0.0) == pytest.approx(10.0)
    assert wave.offered(50.0) == pytest.approx(50.0)
    assert wave.offered(100.0) is None
    raw = {"name": "j", "duration_s": 10, "tick_s": 5}
    assert load_scenario(json.dumps(raw), hosts=4).name == "j"
    p = tmp_path / "sc.json"
    p.write_text(json.dumps(raw))
    assert load_scenario(str(p), hosts=4).name == "j"


def test_decision_checkers_on_hand_made_inputs():
    ds = [{"t": 0.0, "direction": "up", "reason": "q"},
          {"t": 30.0, "direction": "down", "reason": "g"}]
    assert not inv.check_no_flap(ds, 60.0, {}).ok
    assert inv.check_no_flap(ds, 20.0, {}).ok
    one = ds[:1]
    assert not inv.check_no_flap(one, 1.0, {"max_decisions": 0}).ok
    assert not inv.check_no_flap(one, 1.0, {"min_decisions": 2}).ok
    assert not inv.check_no_flap(one, 1.0, {"reasons": ["zz"]}).ok
    assert inv.check_no_flap(one, 1.0, {"reasons": ["q"]}).ok
    late = [{"t": 200.0, "direction": "down", "reason": "q"}]
    assert not inv.check_conservative(
        late, {"no_decisions_during_s": [[150.0, 400.0]]}).ok
    assert inv.check_conservative(
        late, {"no_decisions_during_s": [[300.0, 400.0]]}).ok
    assert not inv.check_convergence(late, 4, 600.0,
                                     {"final_world": [1, 2]}).ok
    assert not inv.check_convergence(late, 1, 210.0,
                                     {"quiet_tail_s": 30.0}).ok
    cyc = [{"t": 0, "wall_s": 0.2, "ok": 3, "down": 1}]
    assert inv.check_scrape_budget(cyc, {"max_scrape_cycle_s": 0.5}).ok
    assert not inv.check_scrape_budget(cyc, {"max_scrape_cycle_s": 0.1}).ok
    assert not inv.check_sink(0.0, {"min_sink_failures": 1}).ok


def test_episode_checker_on_hand_made_inputs():
    def t(state, ep):
        return {"host": 0, "rule": "r", "state": state, "episode": ep}

    double = [t("firing", 1), t("resolved", 1), t("firing", 1)]
    res = inv.check_exactly_once_episodes(double, {})
    assert not res.ok and "episode" in res.detail
    assert not inv.check_exactly_once_episodes(
        [t("firing", 1), t("firing", 2)], {}).ok
    good = [t("firing", 1), t("resolved", 1)]
    assert inv.check_exactly_once_episodes(
        good, {"alert_episodes": {"r": [1, 1]}, "alerts_required": ["r"],
               "all_resolved": True}).ok
    assert not inv.check_exactly_once_episodes(
        good, {"alert_episodes": {"r": [2, 2]}}).ok
    assert not inv.check_exactly_once_episodes(
        good, {"alerts_required": ["other"]}).ok
    assert not inv.check_exactly_once_episodes(
        good[:1], {"all_resolved": True}).ok


def test_serve_checkers_on_hand_made_inputs():
    base = {"requests": 10, "completed": 9, "shed": 1, "lost": 0,
            "duplicates": 0, "amplification": 1.1,
            "budget": {"retries_granted": 2, "retries_denied": 0,
                       "burst": 1.0, "ratio": 0.2, "requests": 10}}
    assert inv.check_request_conservation(base, {}).ok
    assert not inv.check_request_conservation(dict(base, lost=1), {}).ok
    assert not inv.check_request_conservation(base, {"max_shed": 0}).ok
    assert inv.check_retry_amplification(base, {}).ok
    assert not inv.check_retry_amplification(
        dict(base, amplification=1.5), {}).ok
    assert not inv.check_slo_stability({"slo_flaps": 2}, {}).ok
    assert not inv.check_slo_stability({"slo_firing_at_end": True}, {}).ok
    roll = {"rollbacks": 1, "promotions": ["v1"], "rollout_state": "idle",
            "versions_at_end": {"r0": "v1", "r1": "v1"},
            "corrupt_rejected": 1, "corrupt_loaded": 0}
    exp = {"rollbacks": 1, "promotions": ["v1"], "settle_version": "v1",
           "min_corrupt_rejected": 1}
    assert all(r.ok for r in inv.check_serve_scenario(
        dict(base, shed=0, completed=10, **roll), exp))
    assert not inv.check_no_version_skew(
        dict(roll, versions_at_end={"r0": "v1", "r1": "v2"}), exp).ok
    assert not inv.check_corrupt_never_loaded(
        dict(roll, corrupt_loaded=1), exp).ok
    assert not inv.check_zero_dropped(base).ok


def test_standalone_probes():
    assert inv.check_aggregation_scaling(32, budget_s=5.0).ok
    assert inv.check_supervisor_flap(flaps=4, max_retries=2).ok
    fleet = SimFleet(4, VirtualClock(), jitter=0.0)
    assert inv.check_watchdog(fleet, 0, 1, timeout_s=10.0).ok
    for probe in (inv.check_rollup_exactness, inv.check_rollup_bounds,
                  inv.check_staleness_exclusion):
        res = probe()
        assert res.ok, res.detail


def _verdicts(doc) -> list:
    return [(s["name"], s["decisions"], s["episodes"], s["transitions"],
             s["bundles"], s["sink_failures"],
             [(i["name"], i["ok"]) for i in s["invariants"]])
            for s in doc["scenarios"]]


def test_the_entry_point_serial_and_in_workers(tmp_path):
    from bigdl_tpu_torch.sim.__main__ import main

    docs = []
    for jobs in ("1", "2"):
        out = tmp_path / f"sim{jobs}.json"
        rc = main(["--hosts", "8", "--scenarios", "partition,alert_storm",
                   "--compression", "4", "--partition-stall-s", "0.001",
                   "--jobs", jobs, "--out", str(out)])
        doc = json.loads(out.read_text())
        assert rc == 0 and doc["ok"]
        assert [s["name"] for s in doc["scenarios"]] == ["partition",
                                                         "alert_storm"]
        assert doc["bundles"] == doc["scenarios"][1]["episodes"] > 0
        assert [s["name"] for s in doc["serve"]] == list(SERVE_SCENARIOS)
        section = doc["report_fleet_section"]
        assert "partition      PASS" in section
        assert "alert_storm    PASS" in section
        docs.append(doc)
    assert _verdicts(docs[1]) == _verdicts(docs[0])
