"""The port's health, runtime and step telemetry against the JAX
package's, on the CPU.

- ``tree_layer_stats`` and ``flat_shard_stats`` (contiguous, and
  bucketed ``positions`` at world 2: each rank's local sums, added)
  within 1e-5 relative of JAX's (``shard_map`` over 2 devices).
- ``HealthMonitor``: the same stats sequence into both packages'
  monitors gives the same non-finite localization and spike events
  and the same counters.
- Both trainers with ``BIGDL_TORCH_HEALTH_EVERY=2`` against JAX's with
  ``BIGDL_HEALTH_EVERY=2``: each report's per-layer norms within 1e-5
  of the step's largest, the cadence, ``TrainSummary.add_health`` fed.
- ``Reservoir``/``RuntimeStats`` percentiles equal to JAX's; the step
  spans' names and steps; the slow-step event; ``/healthz``'s
  ``step`` and ``"stalled"``; ``evaluate_dataset`` at world 2 over gloo
  against the whole-set fold JAX's ``_allreduce_results`` sums to.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bigdl_tpu import nn as JN
from bigdl_tpu import obs as jobs
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.obs import health as JH
from bigdl_tpu.obs import runtime as JR
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.distri_optimizer import _shard_map
from bigdl_tpu.optim.evaluator import evaluate_dataset as j_evaluate
from bigdl_tpu.resilience import faults as JF
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.obs import health as TH
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs import runtime as TR
from bigdl_tpu_torch.obs import server
from bigdl_tpu_torch.parallel import wire as TW
from bigdl_tpu_torch.resilience import faults as TF

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_distri_worker as W  # noqa: E402

REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_distri_worker.py")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("BIGDL_TORCH_TRACE_DIR", "BIGDL_TORCH_OBS_PORT",
              "BIGDL_TORCH_HEALTH_EVERY", "BIGDL_HEALTH_EVERY",
              "BIGDL_TORCH_HANG_TIMEOUT", "BIGDL_TORCH_FAULT_PLAN",
              "BIGDL_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    Engine.reset()
    tobs.reset()
    jobs.reset()
    TF.reset_injector()
    JF.reset_injector()
    monkeypatch.setattr(JEngine._state, "mesh", _mesh(1), raising=False)
    yield
    Engine.reset()
    tobs.reset()
    jobs.reset()
    TF.reset_injector()
    JF.reset_injector()


def _mesh(n):
    return JEngine.build_mesh({"data": n}, devices=jax.devices()[:n])


def _rel_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert np.all(err <= REL * np.maximum(np.abs(want), 1e-30)), \
        f"{what}: {err.max():.3e}"


def _tree(rs, shapes):
    return [rs.randn(*s).astype(np.float32) for s in shapes]


SHAPES = [(4, 3, 3, 3), (4,), (4,), (3, 4), (3,)]


def test_tree_layer_stats_match_jax():
    rs = np.random.RandomState(0)
    g, p, q = (_tree(rs, SHAPES) for _ in range(3))
    g[1][2] = np.nan
    g[3][0, 1] = np.inf
    want = JH.tree_layer_stats([jnp.asarray(a) for a in g],
                               [jnp.asarray(a) for a in p],
                               [jnp.asarray(a) for a in q])
    got = TH.tree_layer_stats(*([torch.from_numpy(a) for a in t]
                                for t in (g, p, q)))
    assert got.shape == (len(SHAPES), 4)
    finite = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    _rel_close(got.numpy()[finite], np.asarray(want)[finite], "stats")


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["contiguous", "bucketed"])
def test_flat_shard_stats_match_jax_at_world2(bucketed):
    rs = np.random.RandomState(1)
    sizes = [int(np.prod(s)) for s in SHAPES]
    elems, n = sum(sizes), 2
    padded = elems + (-elems) % (n * 8)
    buckets = TW.plan_buckets(padded, n * 8, 48 if bucketed else 0)
    coords = TW.bucket_param_coords(buckets, n)   # shard-major -> flat
    flat = [rs.randn(padded).astype(np.float32) for _ in range(3)]
    for v in flat:
        v[elems:] = 0.0
    flat[0][7] = np.nan
    shard_len = padded // n
    # each rank's shard, in the layout the exchange leaves it in
    shards = [[v[coords[r * shard_len:(r + 1) * shard_len]] for r in range(n)]
              for v in flat]
    bounds = np.cumsum(sizes)
    local = []
    for r in range(n):
        pos = coords[r * shard_len:(r + 1) * shard_len]
        local.append(TH.flat_shard_stats(
            *(torch.from_numpy(s[r]) for s in shards), r * shard_len,
            torch.from_numpy(bounds),
            positions=torch.from_numpy(pos) if bucketed else None,
            reduce=False).numpy())
    got = local[0] + local[1]

    def f(g, w, q, pos):
        idx = jax.lax.axis_index("d")
        return JH.flat_shard_stats(
            g[0], w[0], q[0], idx * shard_len, jnp.asarray(bounds, jnp.int32),
            "d", positions=pos[0] if bucketed else None)[None]

    mesh = JEngine.build_mesh({"d": n}, devices=jax.devices()[:n])
    sm = jax.jit(_shard_map(f, mesh, in_specs=(P("d"),) * 4,
                            out_specs=P("d")))
    stacked = [np.stack(s) for s in shards]
    pos = np.stack([coords[r * shard_len:(r + 1) * shard_len]
                    for r in range(n)]).astype(np.int32)
    want = np.asarray(sm(*stacked, pos))[0]
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    _rel_close(got[finite], want[finite], "flat stats")
    assert got[0, TH.NONFINITE] == 1


class _Events:
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


def _counters(reg, name):
    for fam in reg.families():
        if fam.name == name:
            return {tuple(k): c.value for k, c in fam.child_items()}
    return {}


def test_health_monitor_events_and_counters_match_jax():
    layer_names = ["0/weight", "0/bias", "1/weight"]
    rs = np.random.RandomState(2)
    seq = []
    for step in range(1, 31):
        stats = np.abs(rs.randn(3, 4)).astype(np.float32)
        stats[:, 3] = 0
        loss, ok = 1.0 + 0.01 * rs.rand(), True
        if step == 20:
            stats[0, 0] *= 1e4                  # a gradient-norm spike
        if step == 25:
            stats[1, 3], stats[1, 0], ok = 3, np.nan, False
        if step == 27:
            loss = 1e3                          # a loss spike
        if step == 29:
            loss, ok = float("nan"), False      # loss only
        seq.append((step, stats, ok, loss))
    tev, jev = _Events(), _Events()
    tm = TH.HealthMonitor(layer_names, 2, tracer=tev, window=16)
    jm = JH.HealthMonitor(layer_names, 2, tracer=jev, window=16)
    for step, stats, ok, loss in seq:
        a = tm.on_step(step, torch.from_numpy(stats), ok, loss)
        b = jm.on_step(step, jnp.asarray(stats), ok, loss)
        assert (a is None) == (b is None)
    # every 2nd step, and the two odd steps the guard skipped
    assert tm.fetches == jm.fetches == 17
    assert tm.anomalies == jm.anomalies > 0
    assert [e[0] for e in tev.events] == [e[0] for e in jev.events]
    for (_, ta), (_, ja) in zip(tev.events, jev.events):
        assert json.dumps(ta, sort_keys=True, default=str) == \
            json.dumps(ja, sort_keys=True, default=str)
    for name in (names.NONFINITE_LAYERS_TOTAL, names.NUMERICS_ANOMALIES_TOTAL):
        assert _counters(tobs.get_registry(), name) == \
            _counters(jobs.get_registry(), name) != {}


def test_reservoir_and_runtime_match_jax():
    rs = np.random.RandomState(3)
    vals = rs.exponential(size=300)
    for size in (1, 7, 64, 4096):
        t, j = TR.Reservoir(size), JR.Reservoir(size)
        for v in vals:
            t.add(v)
            j.add(v)
        assert t.summary() == j.summary()
        assert t.percentiles((0.1, 0.5, 0.9, 1.0)) == \
            j.percentiles((0.1, 0.5, 0.9, 1.0))
    rt = TR.RuntimeStats()
    for v in vals[:10]:
        rt.record_step(v)
        rt.record_dispatch("train_step", v / 10)
    snap = rt.snapshot()
    assert snap["step_time_s"]["count"] == 10
    assert snap["host_rss_bytes"] > 0
    assert "device_memory" not in snap          # no card here
    published = tobs.publish_runtime(runtime=rt)
    assert published["step_time_s"]["p50"] == \
        rt.step_times.percentiles()[0.5]
    assert _counters(tobs.get_registry(), names.STEP_TIME_SECONDS)


# ---- through the trainers ------------------------------------------------------
class _Summary:
    def __init__(self):
        self.health = {}

    def add_scalar(self, tag, value, step):
        pass

    def add_health(self, step, layers):
        self.health[step] = layers

    def get_summary_trigger(self, name):
        return None


def _train(pkg, distri, monkeypatch, steps=5, every=2, plan=None):
    x, y = W.data(40)
    if pkg == "jax":
        monkeypatch.setenv("BIGDL_HEALTH_EVERY", str(every))
        if plan:
            monkeypatch.setenv("BIGDL_FAULT_PLAN", plan)
        JRandom.RNG.set_seed(4)
        m = W.small_model(JN)
        opt = (JDistri(m, JArray(x, y, 8, shuffle=False),
                       JN.ClassNLLCriterion(), 8, mesh=_mesh(1),
                       wire_dtype="float32") if distri else
               JO.LocalOptimizer(m, JArray(x, y, 8, shuffle=False),
                                 JN.ClassNLLCriterion(), 8))
        O = JO
    else:
        monkeypatch.setenv("BIGDL_TORCH_HEALTH_EVERY", str(every))
        if plan:
            monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", plan)
        TRandom.RNG.set_seed(4)
        m = W.small_model(TN)
        cls = TO.DistriOptimizer if distri else TO.LocalOptimizer
        kw = dict(wire_dtype="float32") if distri else {}
        opt = cls(m, TArray(x, y, 8, shuffle=False), TN.ClassNLLCriterion(),
                  8, device="cpu", **kw)
        O = TO
    opt.set_optim_method(O.SGD(learningrate=0.2, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(0.1)
    summary = _Summary()
    opt.set_train_summary(summary)
    opt.set_end_when(O.Trigger.max_iteration(steps))
    opt.optimize()
    return opt, summary


@pytest.mark.parametrize("distri", [False, True], ids=["local", "distri"])
def test_trainer_health_reports_match_jax(distri, monkeypatch):
    jopt, jsum = _train("jax", distri, monkeypatch)
    topt, tsum = _train("torch", distri, monkeypatch)
    assert sorted(tsum.health) == sorted(jsum.health) == [2, 4]
    assert topt._health_monitor.fetches == 2
    for step in (2, 4):
        assert list(tsum.health[step]) == list(jsum.health[step])
        for key in ("grad_norm", "param_norm", "update_ratio"):
            # relative to the step's largest value of the key: the conv
            # bias before BN has a gradient of zero, its norm f32
            # rounding noise (~1e-8 of a 0.24 global norm) in both
            floor = max(row[key] for row in jsum.health[step].values())
            pmax = max(row["param_norm"]
                       for row in jsum.health[step].values())
            for layer, row in jsum.health[step].items():
                if key == "update_ratio" and row["param_norm"] < 1e-3 * pmax:
                    continue    # noise over noise: that bias is ~1e-9
                got = tsum.health[step][layer][key]
                assert abs(got - row[key]) <= REL * floor, \
                    (step, layer, key, got, row[key])
    # the clip (0.1) acted: the pre-clip norm is what the report shows
    assert jopt._health_monitor.last["global_grad_norm"] > 0.1
    _rel_close(topt._health_monitor.last["global_grad_norm"],
               jopt._health_monitor.last["global_grad_norm"], "global")


def _nonfinite_report(summary, counters):
    """(health steps, per step the layers with non-finite gradients in
    flat order, the first offender, the counter's per-layer counts)."""
    steps = sorted(summary)
    bad = {s: [n for n, row in summary[s].items() if row["nonfinite"]]
           for s in steps}
    return steps, bad, {k: v for k, v in counters.items()}


def _counting(monkeypatch, name):
    calls = []
    orig = getattr(TH, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(TH, name, wrapped)
    return calls


@pytest.mark.parametrize("distri", [False, True], ids=["local", "distri"])
def test_tripped_step_off_the_cadence_is_localized_as_jax(distri,
                                                          monkeypatch):
    """``nan_grad`` at step 3 with K = 4: JAX fetches at steps 3 and 4
    and names the offenders at step 3; so must the port, and the steps
    that did not trip (1, 2, 5) compute no stats."""
    plan = "step:3:nan_grad"
    jopt, jsum = _train("jax", distri, monkeypatch, every=4, plan=plan)
    calls = _counting(monkeypatch,
                      "flat_shard_stats" if distri else "tree_layer_stats")
    topt, tsum = _train("torch", distri, monkeypatch, every=4, plan=plan)
    jrep = _nonfinite_report(jsum.health, _counters(
        jobs.get_registry(), names.NONFINITE_LAYERS_TOTAL))
    trep = _nonfinite_report(tsum.health, _counters(
        tobs.get_registry(), names.NONFINITE_LAYERS_TOTAL))
    assert jrep[0] == trep[0] == [3, 4]
    assert topt._health_monitor.fetches == jopt._health_monitor.fetches == 2
    assert trep[1] == jrep[1] and len(trep[1][3]) > 0 and trep[1][4] == []
    assert trep[1][3][0] == jrep[1][3][0]
    assert trep[2] == jrep[2]
    assert len(calls) == 2          # step 3 (tripped) and step 4 (K-th)
    for layer, row in jsum.health[3].items():
        got = tsum.health[3][layer]
        assert got["update_ratio"] == row["update_ratio"] == 0.0
        assert abs(got["param_norm"] - row["param_norm"]) <= \
            REL * max(1.0, row["param_norm"])


def test_tripped_step_is_localized_at_world2(tmp_path, monkeypatch):
    """The same fault through ``DistriOptimizer`` at world 2 over gloo
    (the distri worker's ``health`` case): every rank enters the
    deferred stats' ``all_reduce`` on the tripped step, and rank 0's
    report equals JAX's."""
    jopt, jsum = _train("jax", True, monkeypatch, every=4,
                        plan="step:3:nan_grad")
    jrep = _nonfinite_report(jsum.health, _counters(
        jobs.get_registry(), names.NONFINITE_LAYERS_TOTAL))
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, outs[r], "health"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for out in outs:
        with open(out) as f:
            got = json.load(f)
        assert got["steps"] == jrep[0] == [3, 4]
        assert got["fetches"] == 2 and got["stats_calls"] == 2
        assert {int(k): v for k, v in got["bad"].items()} == jrep[1]
        assert {(k,): v for k, v in got["counters"].items()} == jrep[2]


def test_step_spans_and_slow_step(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    x, y = W.data(24)
    TRandom.RNG.set_seed(4)
    opt = TO.LocalOptimizer(W.small_model(TN), TArray(x, y, 8, shuffle=False),
                            TN.ClassNLLCriterion(), 8, device="cpu")
    opt.set_end_when(TO.Trigger.max_iteration(3))
    opt.optimize()
    recent = tobs.get_tracer().recent()
    spans = {}
    for rec in recent:
        if rec["kind"] == "span":
            spans.setdefault(rec["name"], []).append(rec["attrs"].get("step"))
    for name in ("iteration", "batch_prep", "device_put", "step_dispatch",
                 "data_wait", "computing"):
        assert sorted(spans[name])[:3] == [1, 2, 3], (name, spans[name])
    rt = opt._obs_runtime
    assert rt.step_times.count == 3 and rt.dispatch_times.count == 3
    # a step 10x the median, with its child spans from the ring
    for _ in range(8):
        rt.record_step(0.01)
    opt._detect_slow_step(2, 1.0, tobs.get_tracer(), rt)
    slow = [r for r in tobs.get_tracer().recent()
            if r["kind"] == "event" and r["name"] == "slow_step"]
    assert len(slow) == 1 and slow[0]["attrs"]["step"] == 2
    assert {"batch_prep", "device_put", "step_dispatch"} <= \
        set(slow[0]["attrs"]["breakdown"])
    assert _counters(tobs.get_registry(), names.SLOW_STEPS_TOTAL) == {(): 1}


def test_healthz_reads_the_step_and_stalls(monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_OBS_PORT", "0")
    monkeypatch.setenv("BIGDL_TORCH_HANG_TIMEOUT", "0.3")
    x, y = W.data(24)
    TRandom.RNG.set_seed(4)
    opt = TO.DistriOptimizer(W.small_model(TN),
                             TArray(x, y, 8, shuffle=False),
                             TN.ClassNLLCriterion(), 8, device="cpu")
    assert server.health_payload()["status"] == "idle"
    opt.set_end_when(TO.Trigger.max_iteration(3))
    opt.optimize()
    srv = server.get_server()
    with urllib.request.urlopen(srv.url("/healthz"), timeout=10) as r:
        body = json.loads(r.read())
    assert body["step"] == 3 and body["status"] == "ok"
    assert body["step_age_s"] < 0.3
    with urllib.request.urlopen(srv.url("/metrics"), timeout=10) as r:
        text = r.read().decode()
    assert "bigdl_phase_seconds" in text and \
        "bigdl_collective_bytes_total" in text
    time.sleep(0.5)
    body = server.health_payload()
    assert body["status"] == "stalled" and body["step_age_s"] > 0.3


def test_evaluate_dataset_reduces_over_a_world_of_2(tmp_path):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"r{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", store, outs[r], "eval"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    x, y = W.data(24)
    JRandom.RNG.set_seed(4)
    jm = W.small_model(JN)
    want = j_evaluate(jm, JArray(x, y, 8, shuffle=False),
                      [JO.Top1Accuracy(), JO.Loss(JN.ClassNLLCriterion())],
                      mesh=None)
    for out in outs:
        r = np.load(out)
        assert list(r["count"]) == [w.count for w in want] == [24, 24]
        _rel_close(r["total"], [w.total for w in want], "summed results")
