"""The port's fleet readers against the JAX package's, on the CPU:
the trace merge (``obs/aggregate.py``), the rollup tier
(``obs/rollup.py``), the retention store (``obs/retain.py``), the run
report (``obs/report.py``) and the regression gate's CLI
(``obs/regress.py``).

- Both packages' merges of one shard directory, written by the port's
  tracers as two hosts whose clocks disagree, give equal JSON: the
  barrier-aligned offsets, the straggler, every event.
- A two-tier rollup over four hosts' expositions (each a port
  registry): quantiles bit-identical to the flat merge, and the root's
  body equal to JAX's on the same expositions (top-K folding included).
- The retention rings after one ingest sequence equal JAX's, and both
  replay a JSONL with a torn last line to the same rings.
- JAX's ``build_report`` and the port's over one port-written run (a
  LeNet-5 killed after step 6 and resumed, an alert rule firing) give
  equal goodput, alerts and resilience sections.
- ``regress.main`` exits as JAX's on a pass, a violation (with a flight
  bundle) and no baseline.
"""

import json
import os

import pytest

from bigdl_tpu import obs as jobs
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.obs import aggregate as JAgg
from bigdl_tpu.obs import metrics as JM
from bigdl_tpu.obs import regress as JRg
from bigdl_tpu.obs import report as JRep
from bigdl_tpu.obs import retain as JRet
from bigdl_tpu.obs import rollup as JRoll
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models.lenet import build_lenet5
from bigdl_tpu_torch.obs import aggregate as TAgg
from bigdl_tpu_torch.obs import metrics as TM
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs import regress as TRg
from bigdl_tpu_torch.obs import report as TRep
from bigdl_tpu_torch.obs import retain as TRet
from bigdl_tpu_torch.obs import rollup as TRoll
from bigdl_tpu_torch.obs.trace import Tracer
from bigdl_tpu_torch.resilience import elastic as TE

_ENV = ("BIGDL_TORCH_TRACE_DIR", "BIGDL_TORCH_METRICS_DIR",
        "BIGDL_TORCH_ELASTIC_ATTEMPT", "BIGDL_TORCH_GOODPUT_WINDOW",
        "BIGDL_TORCH_ALERT_RULES", "BIGDL_STRAGGLER_FACTOR",
        "BIGDL_TORCH_STRAGGLER_FACTOR")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    Engine.reset()
    tobs.reset()
    jobs.reset()
    jreload()
    yield
    Engine.reset()
    tobs.reset()
    jobs.reset()
    TE.clear_preemption()
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jreload()
    treload()


# ---- the trace merge ------------------------------------------------------------
def _two_hosts(d):
    """Host 0 and host 1, host 1's clock 2.5 s ahead and its steps 3x
    slower from step 3 on; each emits the barrier once."""
    for host, skew, slow in ((0, 0.0, 1.0), (1, 2.5, 3.0)):
        tr = Tracer(d, host_id=host)
        tr._epoch_wall = 1.0e9 + skew
        tr._epoch_perf = 0.0
        tr.event("engine.init_barrier", host=host, processes=2, devices=1)
        for step in range(1, 7):
            dur = 0.1 * (slow if step >= 3 else 1.0)
            tr.complete("computing", 0.2 * step, dur, step=step)
        tr.event("alert.firing", rule="r", severity="warning", episode=1)
        tr.close()


def test_both_merges_of_one_shard_dir_are_equal(tmp_path):
    d = str(tmp_path / "tr")
    _two_hosts(d)
    # the barrier's wall times are the tracers' own clocks: pin them
    for sh in TAgg.read_shards(d):
        assert sh.barrier_wall() is not None
    jdoc = JAgg.merge_shards(JAgg.read_shards(d))
    tdoc = TAgg.merge_shards(TAgg.read_shards(d))
    assert json.loads(json.dumps(tdoc)) == json.loads(json.dumps(jdoc))
    offsets = sorted(tdoc["otherData"]["offsets_s"].values())
    assert offsets[0] == 0.0 and offsets[1] == pytest.approx(2.5, abs=0.1)
    assert tdoc["otherData"]["stragglers"]["stragglers"] == [1]
    assert tdoc["otherData"]["unaligned"] == []
    out = str(tmp_path / "merged.json")
    assert TAgg.main([d, "-o", out]) == 0
    with open(out) as f:
        assert json.load(f)["otherData"]["merged_shards"] == 2
    summary = TAgg.merge_trace_dir(d)
    assert summary["shards"] == 2 and summary["stragglers"] == [1]


# ---- the rollup tier -----------------------------------------------------------
def _host_body(i):
    reg = TM.MetricsRegistry()
    h = reg.histogram(names.REQUEST_LATENCY_SECONDS, "lat",
                      labels=("engine", "kind"))
    for k in range(20 + 7 * i):
        h.labels(engine="lm", kind="e2e").observe(0.003 * (k + 1) * (i + 1))
    reg.counter(names.SERVE_TOKENS_TOTAL, "tokens").inc(100 * (i + 1))
    reg.gauge(names.GOODPUT_RATIO, "g").set(0.5 + 0.1 * i)
    reg.gauge(names.STEP_TIME_SECONDS, "st", labels=("quantile",)).labels(
        quantile="p50").set(0.1 * (i + 1))
    stale = reg.gauge(names.HEARTBEAT_AGE_SECONDS, "hb", labels=("host",))
    for p in range(5):
        stale.labels(host=f"{i}-{p}").set(float(i + p))
    return reg.to_prometheus()


def test_two_tier_rollup_is_bit_identical_and_equals_jax():
    bodies = {f"h{i}:9100": _host_body(i) for i in range(4)}
    addrs = sorted(bodies)

    def fetch(url):
        host, _, path = url.split("//", 1)[1].partition("/")
        if path.startswith("healthz"):
            return json.dumps({"time": 1000.0, "host": host})
        return bodies[host]

    out = {}
    for name, R, M in (("t", TRoll, TM), ("j", JRoll, JM)):
        root, leaves = R.build_tiers(addrs, fetch, shard_size=2, top_k=3,
                                     clock=lambda: 1000.0)
        tiered = root.refresh()
        flat = R.merge_parsed([M.parse_prometheus(bodies[a])
                               for a in addrs])
        for q in (0.5, 0.9, 0.99):
            t = R.fleet_quantile(tiered, names.REQUEST_LATENCY_SECONDS, q,
                                 kind="e2e")
            assert t is not None
            assert t == R.fleet_quantile(flat, names.REQUEST_LATENCY_SECONDS,
                                         q, kind="e2e")
        out[name] = (M.render_exposition(tiered), len(leaves),
                     root.tracked_series)
    # the samples and the types equal JAX's (a HELP line is each
    # package's own wording of a declared family)
    t, j = TM.parse_prometheus(out["t"][0]), JM.parse_prometheus(out["j"][0])
    assert t["samples"] == j["samples"] and out["t"][1:] == out["j"][1:]
    assert {k: v["type"] for k, v in t["families"].items()} == \
        {k: v["type"] for k, v in j["families"].items()}
    assert "other" in out["t"][0]          # the top-K bound folded


# ---- the retention store -----------------------------------------------------------
def _fill(R, M, d):
    st = R.RetentionStore(max_series=3, points_per_ring=4, directory=d,
                          registry=M.MetricsRegistry())
    for k in range(30):
        t = 1000.0 + 3.7 * k
        st.ingest(t, names.GOODPUT_RATIO, 0.5 + 0.01 * (k % 7))
        st.ingest(t, names.SERVE_QUEUE_DEPTH, float(k % 5))
        st.ingest(t, names.FLEET_SCRAPE_SECONDS, 0.01 * k,
                  labels={"x": str(k % 2)})
    st.flush()
    return st


def _rings(st):
    return {sid: {r: list(dq) for r, dq in rings.items()}
            for sid, rings in st._series.items()}


def test_retention_rings_equal_jax(tmp_path):
    t = _fill(TRet, TM, str(tmp_path / "t"))
    j = _fill(JRet, JM, str(tmp_path / "j"))
    assert _rings(t) == _rings(j) and t.summary() == j.summary()
    assert t._rejected == j._rejected > 0      # the series budget held
    path = str(tmp_path / "t" / "retain.jsonl")
    with open(path, "a") as f:
        f.write('{"points": [[1.0, "bigdl_goodput_ratio", {}, 0.')  # torn
    a = TRet.RetentionStore(max_series=3, points_per_ring=4,
                            directory=str(tmp_path / "t"),
                            registry=TM.MetricsRegistry())
    b = JRet.RetentionStore(max_series=3, points_per_ring=4,
                            directory=str(tmp_path / "t"),
                            registry=JM.MetricsRegistry())
    assert a.load() == b.load() == 90 - t._rejected
    assert _rings(a) == _rings(b) == _rings(t)
    assert TRet.sparkline([1, 2, 3]) == JRet.sparkline([1, 2, 3])


# ---- the report over a port-written run ----------------------------------------------
class _Kill:
    def __init__(self, at):
        self.at = at

    def add_scalar(self, tag, value, step):
        if tag == "Loss" and step == self.at:
            raise SystemExit(1)

    def get_summary_trigger(self, name):
        return None


def test_jax_report_reads_a_port_run_as_the_port_does(tmp_path, monkeypatch):
    tdir, mdir = str(tmp_path / "tr"), str(tmp_path / "m")
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", tdir)
    monkeypatch.setenv("BIGDL_TORCH_METRICS_DIR", mdir)
    monkeypatch.setenv("BIGDL_TORCH_GOODPUT_WINDOW", "2")
    monkeypatch.setenv("BIGDL_TORCH_ALERT_RULES", json.dumps([
        {"name": "window", "type": "threshold",
         "metric": names.GOODPUT_WINDOW_RATIO, "op": "<", "value": 1.01,
         "for": 2}]))
    ck = str(tmp_path / "ck")
    for attempt, kill in ((0, 6), (1, None)):
        monkeypatch.setenv("BIGDL_TORCH_ELASTIC_ATTEMPT", str(attempt))
        TRandom.RNG.set_seed(0)
        x, y = load_mnist(None, "train", synthetic_n=256)
        opt = TO.DistriOptimizer(build_lenet5(device="cpu"),
                                 TArray(normalize(x), y, 32, shuffle=False),
                                 TN.ClassNLLCriterion(), 32, device="cpu",
                                 wire_dtype="float32")
        opt.set_optim_method(TO.SGD(learningrate=0.1))
        opt.set_end_when(TO.Trigger.max_iteration(8))
        opt.set_checkpoint(ck, TO.Trigger.several_iteration(4))
        opt.set_train_summary(_Kill(kill))
        if attempt:
            TE.restore_latest(opt)
        try:
            opt.optimize()
        except SystemExit:
            pass
        tobs.flush()
        tobs.reset()
        Engine.reset()
    t, j = TRep.build_report(tdir, mdir), JRep.build_report(tdir, mdir)
    for section in ("goodput", "alerts", "resilience_events"):
        assert json.loads(json.dumps(t[section], default=str)) == \
            json.loads(json.dumps(j[section], default=str)), section
    assert t["goodput"]["rework_steps"] == 2
    assert t["alerts"]["fired_total"] == {"window[warning]": 1.0}
    events = t["alerts"]["events"]
    assert events and {e["rule"] for e in events} == {"window"}
    text = TRep.render_text(t)
    for head in ("-- goodput --", "-- alerts --", "-- resilience events --"):
        assert head in text
    assert TRep.main([tdir, "--metrics-dir", mdir, "--json"]) == 0


# ---- the regression gate's CLI --------------------------------------------------
def _bench(path, step, value):
    with open(path, "w") as f:
        json.dump({"parsed": {"platform": "gpu", "value": value,
                              "extras": {"step_time_s": step}}}, f)


@pytest.mark.parametrize("case,step,value,code", [
    ("pass", 0.11, 95.0, 0), ("violation", 0.5, 20.0, 1),
    ("no_baseline", None, None, 0)])
def test_regress_main_exits_as_jax(tmp_path, case, step, value, code,
                                   capsys):
    traj = tmp_path / "traj"
    traj.mkdir()
    if case != "no_baseline":
        _bench(str(traj / "BENCH_r01.json"), 0.1, 100.0)
        _bench(str(traj / "BENCH_r02.json"), 0.12, 90.0)
    fresh = str(tmp_path / "fresh.json")
    _bench(fresh, step if step else 0.2, value if value else 50.0)
    codes = {}
    for name, R in (("t", TRg), ("j", JRg)):
        flight = str(tmp_path / f"flight_{name}")
        codes[name] = R.main(["--fresh", fresh, "--trajectory", str(traj),
                              "--flight-dir", flight, "--json"])
        verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert verdict["status"] == case
        if case == "violation":
            with open(verdict["flight_recorder"]) as f:
                bundle = json.load(f)
            assert bundle["kind"] == "bigdl_flight_recorder"
            assert set(bundle) >= {"spans", "metrics", "runtime", "health",
                                   "verdict"}
        codes[name, "verdict"] = {k: v for k, v in verdict.items()
                                  if k != "flight_recorder"}
    assert codes["t"] == codes["j"] == code
    assert codes["t", "verdict"] == codes["j", "verdict"]
