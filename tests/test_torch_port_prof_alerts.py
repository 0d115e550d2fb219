"""The port's sampling profiler, alert engine, debug bundles and the
``/profilez``, ``/debugz`` and ``/healthz`` bodies against the JAX
package's, on the CPU.

- A thread parked in a known function under a known span (entered on
  both packages' tracers): each package's profiler folds it to the same
  span-prefixed stack, and the same per-phase self-time table.
- The budget: with an injected wall clock and work clock, a sample that
  takes the work ratio past the budget makes the next periods skip
  until the ratio is back under it; a collector pass on the sampler's
  thread is not charged.
- One rule pack (threshold with ``for`` and ``resolve_for``, absence,
  rate, burn rate) over one metric sequence on a synthetic clock: the
  same transitions, values and episode ids in both packages.
- A bundle's file set equals JAX's, ``verify_bundle`` passes in either
  package on either's bundle, a ``.tmp`` leftover and a changed byte
  are rejected, the per-rule rate limit holds, an episode bundles once.
- ``/profilez``, ``/debugz`` and ``/healthz`` answer with JAX's keys.
"""

import gc
import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.obs import alerts as JA
from bigdl_tpu.obs import bundle as JB
from bigdl_tpu.obs import metrics as JM
from bigdl_tpu.obs import prof as JP
from bigdl_tpu.obs import server as jserver
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.obs import alerts as TA
from bigdl_tpu_torch.obs import bundle as TB
from bigdl_tpu_torch.obs import metrics as TM
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs import prof as TP
from bigdl_tpu_torch.obs import server as tserver

_ENV = ("BIGDL_TRACE_DIR", "BIGDL_TORCH_TRACE_DIR", "BIGDL_BUNDLE_DIR",
        "BIGDL_TORCH_BUNDLE_DIR", "BIGDL_OBS_PORT", "BIGDL_TORCH_OBS_PORT",
        "BIGDL_PROF_HZ", "BIGDL_TORCH_PROF_HZ", "BIGDL_BUNDLE_RATE_LIMIT",
        "BIGDL_TORCH_BUNDLE_RATE_LIMIT", "BIGDL_ALERT_RULES",
        "BIGDL_TORCH_ALERT_RULES")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jreload()
    tobs.reset()
    jobs.reset()
    yield
    tobs.reset()
    jobs.reset()
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jreload()
    treload()


# ---- the profiler -------------------------------------------------------------
def parked_here(event):
    event.wait(30)


def test_a_parked_thread_folds_to_the_same_stack(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TRACE_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "t"))
    jreload()
    inside, release = threading.Event(), threading.Event()

    def body():
        with jobs.get_tracer().span("train.park"), \
                tobs.get_tracer().span("train.park"):
            inside.set()
            parked_here(release)

    th = threading.Thread(target=body, name="parked")
    th.start()
    assert inside.wait(10)
    # hz so low that the samplers' own threads never fire: the test
    # takes each sample itself
    jp, tp = JP.SamplingProfiler(1e-4), TP.SamplingProfiler(1e-4)
    try:
        me = threading.get_ident()
        jp._sample(me)
        tp._sample(me)
    finally:
        release.set()
        th.join(10)
        jp.close()
        tp.close()
    js, ts = jp.snapshot(), tp.snapshot()
    jpark = [c for c in js["collapsed"] if c.startswith("train.park;")]
    tpark = [c for c in ts["collapsed"] if c.startswith("train.park;")]
    assert tpark == jpark and len(tpark) == 1
    assert "test_torch_port_prof_alerts.py:body;test_torch_port_prof_"\
        "alerts.py:parked_here;threading.py:wait" in tpark[0]
    assert ts["phases"]["train.park"] == js["phases"]["train.park"]
    assert set(ts) == set(js)
    assert TP.NULL_PROFILER.snapshot() == JP.NULL_PROFILER.snapshot()


def test_the_budget_skips_samples(monkeypatch):
    wall, work = [0.0], [0.0]
    tp = TP.SamplingProfiler(1e-4, budget=0.01, clock=lambda: wall[0],
                             work_clock=lambda: work[0])
    cost = [0.002]

    def sample(me):
        work[0] += cost[0]
    tp._sample = sample
    try:
        wall[0] = 1.0
        assert tp._tick(0)                  # 0 / 1 s: within budget
        assert tp.overhead_ratio() == pytest.approx(0.002)
        cost[0] = 0.02
        wall[0] = 1.01
        assert tp._tick(0)                  # 0.002 / 1.01: still within
        taken = [tp._tick(0) for _ in range(3)]
        assert taken == [False, False, False]
        assert tp._skipped == 3
        wall[0] = 2.3                       # 0.022 / 2.3 < 0.01 again
        assert tp._tick(0)
        # a collector pass that starts on the sampler's thread is timed
        # apart and not charged
        before = tp._work_s

        def collecting(me):
            tp._on_gc("start", {})
            work[0] += 0.5
            tp._on_gc("stop", {})
            work[0] += 0.001
        tp._sample = collecting
        wall[0] = 1e3
        assert tp._tick(0)
        assert tp._work_s - before == pytest.approx(0.001)
    finally:
        tp.close()
    assert tp._on_gc not in gc.callbacks
    assert tp.snapshot()["skipped"] == 3


# ---- alerts ------------------------------------------------------------------
RULES = [
    {"name": "low_goodput", "type": "threshold",
     "metric": names.GOODPUT_WINDOW_RATIO, "op": "<", "value": 0.5,
     "for": 2, "resolve_for": 2, "severity": "critical"},
    {"name": "no_heartbeat", "type": "absence",
     "metric": names.HEARTBEAT_AGE_SECONDS},
    {"name": "skips", "type": "rate", "metric": names.NONFINITE_SKIPS_TOTAL,
     "op": ">", "value": 0},
    {"name": "burn", "type": "burn_rate", "metric": names.GOODPUT_RATIO,
     "slo": 0.9, "threshold": 2.0, "for": 1},
]
# (window ratio, goodput ratio, skips added, heartbeat age or None)
SEQ = [(0.9, 0.95, 0, None), (0.4, 0.9, 0, None), (0.3, 0.7, 1, 3.0),
       (0.45, 0.6, 0, 3.0), (0.7, 0.85, 2, 1.0), (0.2, 0.95, 0, 1.0),
       (0.8, 0.99, 0, None), (0.9, 0.99, 0, None), (0.1, 0.5, 0, None),
       (0.05, 0.5, 0, None)]


def _transitions(A, M):
    reg = M.MetricsRegistry()
    eng = A.AlertEngine(A.load_rules(json.dumps(RULES)), registry=reg,
                        clock=lambda: 0.0)
    out = []
    for t, (win, ratio, skips, age) in enumerate(SEQ):
        reg.gauge(names.GOODPUT_WINDOW_RATIO).set(win)
        reg.gauge(names.GOODPUT_RATIO).set(ratio)
        if skips:
            reg.counter(names.NONFINITE_SKIPS_TOTAL).inc(skips)
        if age is not None:
            reg.gauge(names.HEARTBEAT_AGE_SECONDS,
                      labels=("host",)).labels(host="1").set(age)
        out.append(eng.evaluate(now=100.0 + t))
    return out, eng.active(), reg.to_prometheus()


def test_the_same_rule_pack_transitions_as_jax():
    got, t_active, t_text = _transitions(TA, TM)
    want, j_active, j_text = _transitions(JA, JM)
    assert got == want
    flat = [(x["rule"], x["state"], x["episode"]) for ts in got for x in ts]
    assert ("low_goodput", "firing", 2) in flat
    assert ("skips", "firing", 2) in flat and ("burn", "firing", 2) in flat
    assert t_active == j_active
    assert TM.parse_prometheus(t_text) == JM.parse_prometheus(j_text)
    assert TA.default_rules(30.0) == JA.default_rules(30.0)
    assert TA.burn_rate(0.8, 0.9) == JA.burn_rate(0.8, 0.9)
    with pytest.raises(ValueError):
        TA.load_rules('[{"name": "x", "type": "nope", "metric": "m"}]')


# ---- bundles ---------------------------------------------------------------------
def test_bundles_carry_jaxs_files_and_verify_across_packages(tmp_path):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tb = TB.build_bundle(reason="test", bundle_dir=tdir)
    jb = JB.build_bundle(reason="test", bundle_dir=jdir)
    assert sorted(os.listdir(tb)) == sorted(os.listdir(jb))
    assert set(TB.BUNDLE_FILES) == set(JB.BUNDLE_FILES)
    for v in (TB.verify_bundle, JB.verify_bundle):
        assert v(tb)[0] and v(jb)[0]
    with open(os.path.join(tb, "MANIFEST.json")) as f:
        tm = json.load(f)
    with open(os.path.join(jb, "MANIFEST.json")) as f:
        jm = json.load(f)
    assert set(tm) == set(jm) and set(tm["files"]) == set(jm["files"])
    with open(os.path.join(tb, "runtime.json")) as f:
        assert "step_time_s" in json.load(f)
    # an interrupted write and a changed byte are rejected
    os.rename(tb, tb + ".tmp")
    assert TB.verify_bundle(tb + ".tmp") == JB.verify_bundle(tb + ".tmp")
    assert not TB.verify_bundle(tb + ".tmp")[0]
    os.rename(tb + ".tmp", tb)
    with open(os.path.join(tb, "ring.json"), "a") as f:
        f.write(" ")
    ok, why = TB.verify_bundle(tb)
    assert not ok and "ring.json" in why
    inv = TB.inventory(tdir)
    assert [b["ok"] for b in inv] == [False]
    assert [b["ok"] for b in JB.inventory(tdir)] == [False]


def test_the_rate_limit_and_one_bundle_an_episode(tmp_path, monkeypatch):
    d = str(tmp_path / "b")
    monkeypatch.setenv("BIGDL_TORCH_BUNDLE_DIR", d)
    monkeypatch.setenv("BIGDL_TORCH_BUNDLE_RATE_LIMIT", "300")
    first = {"rule": "r", "episode": 1}
    assert TB.on_alert_firing(first, engine_uid=7)
    assert TB.on_alert_firing(first, engine_uid=7) is None  # same episode
    # the next episode of the rule inside the limit: no bundle
    assert TB.on_alert_firing({"rule": "r", "episode": 2},
                              engine_uid=7) is None
    # another rule is its own limit
    assert TB.on_alert_firing({"rule": "s", "episode": 1}, engine_uid=7)
    monkeypatch.setenv("BIGDL_TORCH_BUNDLE_RATE_LIMIT", "0")
    assert TB.on_alert_firing({"rule": "r", "episode": 3}, engine_uid=7)
    inv = TB.inventory(d)
    assert len(inv) == 3 and all(b["ok"] and b["trigger"] == "alert"
                                 for b in inv)
    monkeypatch.delenv("BIGDL_TORCH_BUNDLE_DIR")
    assert TB.on_alert_firing({"rule": "q", "episode": 1}) is None


# ---- the endpoints ---------------------------------------------------------------
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profilez_debugz_healthz_bodies_have_jaxs_keys(tmp_path,
                                                       monkeypatch):
    for pre in ("BIGDL_", "BIGDL_TORCH_"):
        monkeypatch.setenv(pre + "OBS_PORT", "0")
        monkeypatch.setenv(pre + "PROF_HZ", "50")
        monkeypatch.setenv(pre + "BUNDLE_DIR",
                           str(tmp_path / pre.lower()))
    jreload()
    js, ts = jserver.ensure_server(), tserver.ensure_server()
    JP.get_profiler()
    TP.get_profiler()
    bodies = {}
    for name, srv in (("j", js), ("t", ts)):
        for path in ("/profilez", "/debugz", "/healthz", "/"):
            bodies[name, path] = _get(srv.url(path))
    for path in ("/profilez", "/debugz", "/healthz", "/"):
        (jc, jb), (tc, tb) = bodies["j", path], bodies["t", path]
        assert tc == jc == 200, (path, tb)
        assert set(tb) == set(jb), path
    assert bodies["t", "/"][1] == bodies["j", "/"][1]
    t_health = bodies["t", "/healthz"][1]
    assert t_health["bundles"] == 1 and t_health["prof_overhead"] is not None
    assert bodies["t", "/profilez"][1]["enabled"] is True
    debugz = bodies["t", "/debugz"][1]
    assert TB.verify_bundle(debugz["bundle"])[0]
    assert [b["trigger"] for b in debugz["inventory"]] == ["http"]
    with urllib.request.urlopen(ts.url("/profilez?format=collapsed"),
                                timeout=10) as r:
        assert r.status == 200
