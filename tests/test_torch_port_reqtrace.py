"""The port's request tracing and telemetry (``ReqTraceCollector``, the
engine's span partition, ``Tracer``, the metrics registry's exemplars,
Prometheus export and strict mode, ``ObsServer``) against the JAX
package on the CPU.

Limits: the tail sampler's keep/drop decisions, reasons, kept span
sets (their names, durations and attributes; the wall-clock start
aside) and counters equal JAX's exactly for the same trace ids and
outcomes (a hypothesis property); the engine's queue + prefill +
preempt + decode spans sum to its e2e within 1e-6 s, and name the same
hops as JAX's engine for the same pumped requests; tokens with tracing
on equal tokens with it off; ``to_prometheus`` equals JAX's text for
the same family contents, exemplar timestamps aside; strict mode raises
where JAX's does.  Servers bind ephemeral ports; both packages'
telemetry is reset around each test."""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.obs import metrics as jmetrics
from bigdl_tpu.obs import reqtrace as jrt
from bigdl_tpu.obs import server as jserver
from bigdl_tpu.serving import LMEngine as JEngine
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.obs import metrics as tmetrics
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs import reqtrace as trt
from bigdl_tpu_torch.obs import server as tserver
from bigdl_tpu_torch.serving import (EngineReplica, HTTPReplica, LMEngine,
                                     Router, RouterServer, ServingServer,
                                     spans)
from bigdl_tpu_torch.utils.convert import load_jax_params

TINY = dict(dim=32, n_head=4, n_layer=2, max_len=64)
VOCAB = 64
PARTITION_TOL = 1e-6
ENGINE_HOPS = {spans.SPAN_QUEUE, spans.SPAN_PREFILL, spans.SPAN_PREEMPT,
               spans.SPAN_DECODE}


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for var in ("BIGDL_TORCH_REQTRACE_SAMPLE", "BIGDL_TORCH_REQTRACE_RING",
                "BIGDL_TORCH_TRACE_DIR", "BIGDL_TORCH_OBS_PORT",
                "BIGDL_TORCH_OBS_STRICT", "BIGDL_REQTRACE_SAMPLE",
                "BIGDL_REQTRACE_RING", "BIGDL_TRACE_DIR", "BIGDL_OBS_PORT",
                "BIGDL_OBS_STRICT", "BIGDL_OBS", "BIGDL_METRICS_DIR"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lms():
    JRandom.RNG.set_seed(13)
    jm = j_build(VOCAB, attn_impl="xla", **TINY)
    tm = t_build(VOCAB, attn_impl="reference", device="cpu", **TINY)
    load_jax_params(tm, _np(jm.params()))
    return jm, tm


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _no_start(entry):
    """A ring entry with the wall-clock span starts left out."""
    out = dict(entry)
    out["spans"] = [{k: v for k, v in s.items() if k != "start"}
                    for s in entry["spans"]]
    return out


# -------------------------------------------------------------- sampler
_finish = st.fixed_dictionaries({
    "error": st.sampled_from([None, None, "boom"]),
    "retries": st.integers(0, 2), "preempted": st.booleans(),
    "slo_violation": st.booleans(), "handoff": st.booleans(),
    "e2e_s": st.one_of(st.none(), st.floats(0.0, 5.0))})


@settings(max_examples=50, deadline=None)
@given(sample=st.sampled_from([1e-9, 0.3, 0.5, 1.0]),
       ring=st.integers(1, 6),
       traces=st.lists(st.tuples(
           st.integers(0, 7), st.booleans(),
           st.lists(st.tuples(st.sampled_from(sorted(ENGINE_HOPS)),
                              st.floats(0.0, 9.0), st.floats(0.0, 2.0)),
                    max_size=4),
           st.sampled_from([None, "r1", "r2"]), _finish), max_size=14))
def test_collector_decisions_equal_jax(sample, ring, traces):
    """Trace ids finish (some twice, as a handoff's replay does) with the
    same outcomes: the same keep/drop and reasons, ring, lookups and
    counters."""
    tc, jc = trt.ReqTraceCollector(sample, ring), \
        jrt.ReqTraceCollector(sample, ring)
    for tid, keep, hops, request, kw in traces:
        tctx = trt.RequestTraceContext(f"t{tid}", keep=keep)
        jctx = jrt.RequestTraceContext(f"t{tid}", keep=keep)
        tc.begin(tctx)
        jc.begin(jctx)
        for name, start, dur in hops:
            tc.span(tctx, name, start, dur, engine="lm")
            jc.span(jctx, name, start, dur, engine="lm")
        assert tc.finish(tctx, request=request, **kw) == \
            jc.finish(jctx, request=request, **kw)
        assert tctx.keep == jctx.keep
    assert [_no_start(e) for e in tc.completed()] == \
        [_no_start(e) for e in jc.completed()]
    assert tc.stats() == jc.stats()
    for key in ("t0", "t3", "r1", "r2", "nope"):
        t, j = tc.find(key), jc.find(key)
        assert (t is None) == (j is None)
        if t is not None:
            assert _no_start(t) == _no_start(j)


def test_hash_and_header_equal_jax():
    for i in range(50):
        assert trt._hash01(f"id{i}") == jrt._hash01(f"id{i}")
    for h in ("abc:7:k", "deadbeef::", "tid:notanint:k", "", "::k"):
        t, j = trt.RequestTraceContext.from_header(h), \
            jrt.RequestTraceContext.from_header(h)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.trace_id, t.parent, t.keep, t.to_header()) == \
                (j.trace_id, j.parent, j.keep, j.to_header())


def test_disabled_collector_is_the_null_one(monkeypatch):
    col = trt.get_collector()
    assert col is trt.NULL_COLLECTOR and not col.enabled
    assert col.find("x") is None and col.completed() == []
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "0.5")
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_RING", "3")
    col = trt.get_collector()
    assert col.enabled and col.sample == 0.5 and col.ring_size == 3
    assert trt.get_collector() is col


def test_getters_rebuild_on_a_knob_change_only(tmp_path, monkeypatch):
    """The collector and the tracer come back cached while their knobs
    read as at the last call, anew when a knob changes, and as the null
    ones when it is unset; ``obs.reset`` drops the cached ones."""
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "1")
    col = trt.get_collector()
    assert col.enabled and trt.get_collector() is col
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_RING", "5")
    col2 = trt.get_collector()
    assert col2 is not col and col2.ring_size == 5
    obs.reset()
    col3 = trt.get_collector()
    assert col3 is not col2 and col3.enabled and col3.ring_size == 5
    monkeypatch.delenv("BIGDL_TORCH_REQTRACE_SAMPLE")
    assert trt.get_collector() is trt.NULL_COLLECTOR
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "a"))
    tr = obs.get_tracer()
    assert tr.enabled and obs.get_tracer() is tr
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "b"))
    tr2 = obs.get_tracer()
    assert tr2 is not tr and tr2.enabled and tr._closed
    monkeypatch.delenv("BIGDL_TORCH_TRACE_DIR")
    assert obs.get_tracer() is obs.NULL_TRACER and tr2._closed
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "c"))
    tr3 = obs.get_tracer()
    obs.reset()
    assert tr3._closed and obs.get_tracer() is not tr3


# --------------------------------------------------------------- engines
def _traced_run(eng_cls, model, prompts, n_new, kw):
    """Submit every prompt, wait until the queue holds them all (the JAX
    queue moves each into its buffer on a thread), pump to idle."""
    eng = eng_cls(model, max_batch=2, **kw)
    reqs = [eng.submit(p, n_new) for p in prompts]
    depth = getattr(eng.queue, "_buf", eng.queue).depth
    deadline = time.monotonic() + 60
    while depth() < len(prompts) and time.monotonic() < deadline:
        time.sleep(0.001)
    assert depth() == len(prompts)
    eng.run_until_idle(120)
    eng.close()
    return reqs


# (prompt lengths, new tokens, engine settings): at 4-token pages and 8
# pages the two requests cannot both stay resident, so one is preempted
ENGINE_CASES = {"plain": ((5, 9, 12), 6, {"page_size": 8}),
                "preempted": ((5, 9), 12, {"page_size": 4, "num_pages": 8})}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_partition_is_exact_and_hops_equal_jax(lms, monkeypatch,
                                                      case):
    """Tracing on: tokens equal the untraced run's; every kept trace's
    engine hops sum to the request's e2e within 1e-6 s and name the same
    hops (with the same buckets, slots and token counts) as JAX's
    engine; a preempted request's trace keeps a ``req.preempt`` span."""
    jm, tm = lms
    lens, n_new, kw = ENGINE_CASES[case]
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, VOCAB, (n,)).tolist() for n in lens]
    untraced = _traced_run(LMEngine, tm, prompts, n_new,
                           {"device": "cpu", **kw})
    assert all(r.trace is None for r in untraced)
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "1.0")
    monkeypatch.setenv("BIGDL_REQTRACE_SAMPLE", "1.0")
    traced = _traced_run(LMEngine, tm, prompts, n_new,
                         {"device": "cpu", **kw})
    jreqs = _traced_run(JEngine, jm, prompts, n_new, kw)
    col, jcol = trt.get_collector(), jrt.get_collector()
    assert [r.tokens for r in traced] == [r.tokens for r in untraced] \
        == [[int(t) for t in r.tokens] for r in jreqs]
    preempted = 0
    for r, jr in zip(traced, jreqs):
        entry = col.find(r.trace.trace_id)
        jentry = jcol.find(jr.trace.trace_id)
        hops = [s for s in entry["spans"] if s["name"] in ENGINE_HOPS]
        assert hops == entry["spans"]
        assert abs(sum(s["dur_s"] for s in hops) - entry["e2e_s"]) \
            <= PARTITION_TOL
        assert entry["e2e_s"] == r.e2e_s
        drop = ("start", "dur_s")
        assert [{k: v for k, v in s.items() if k not in drop}
                for s in entry["spans"]] == \
            [{k: v for k, v in s.items() if k not in drop}
             for s in jentry["spans"]]
        assert (entry["reason"], entry["request"]) == \
            (jentry["reason"], str(r.id))
        preempted += any(s["name"] == spans.SPAN_PREEMPT for s in hops)
    assert (preempted > 0) == (case == "preempted")
    assert col.stats()["sampled"] == jcol.stats()["sampled"]


def test_exemplar_rides_the_latency_histogram(lms, monkeypatch):
    _, tm = lms
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "1.0")
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    req = eng.submit([1, 2, 3], 4)
    eng.run_until_idle(60)
    eng.close()
    parsed = tmetrics.parse_prometheus(obs.get_registry().to_prometheus())
    ex = [s["exemplar"] for s in parsed["samples"]
          if s["name"] == names.REQUEST_LATENCY_SECONDS + "_bucket"
          and "exemplar" in s]
    assert ex and ex[0]["labels"] == {"trace_id": req.trace.trace_id}
    assert ex[0]["value"] == pytest.approx(req.e2e_s)


def test_drain_handoff_trace_spans_both_engines(lms, monkeypatch):
    """A queued request drained at deadline 0: its trace is kept (a
    handoff) and the record's header carries the keep flag; the replay
    under the same context joins the same ring entry, as in JAX."""
    jm, tm = lms
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "0.000000001")
    e1 = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    e2 = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    p = [1, 2, 3, 4]
    req = e1.submit(p, 6)
    (hd,) = e1.drain(0.0)
    ctx = trt.RequestTraceContext.from_header(hd.trace)
    assert ctx.trace_id == req.trace.trace_id and ctx.keep
    req2 = e2.submit(hd.prompt, hd.max_new_tokens, trace=ctx)
    e2.run_until_idle(60)
    e1.close()
    e2.close()
    col = trt.get_collector()
    entry = col.find(ctx.trace_id)
    assert [s["name"] for s in entry["spans"]] == [
        spans.SPAN_HANDOFF, spans.SPAN_QUEUE, spans.SPAN_PREFILL,
        spans.SPAN_DECODE]
    assert col.stats()["sampled"] == {"handoff": 1}
    assert p + req2.tokens == [int(t) for t in np.asarray(jm.generate(
        jm.params(), np.asarray(p)[None], 6))[0]]


def test_one_trace_through_router_server_and_serving_server(lms,
                                                            monkeypatch):
    """RouterServer -> HTTPReplica -> ServingServer -> LMEngine: the
    router's and the engine's hops share one trace id, found by the
    router's request id through ``/trace?request=ID``."""
    jm, tm = lms
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "1.0")
    monkeypatch.setenv("BIGDL_TORCH_OBS_PORT", "0")
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu").start()
    srv = ServingServer(lm=eng, port=0)
    front = RouterServer(Router([HTTPReplica("h", srv.url(""))],
                                request_timeout_s=60.0), port=0)
    obs_srv = tserver.ensure_server()
    try:
        body = json.dumps({"prompt": [5, 9, 2, 6],
                           "max_new_tokens": 6}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                front.url("/v1/generate"), data=body,
                headers={"Content-Type": "application/json"}),
                timeout=60) as r:
            out = json.loads(r.read())
        code, text = _get(obs_srv.url(f"/trace?request={out['id']}"))
    finally:
        front.close()
        srv.close()
        eng.close()
    assert code == 200
    served = json.loads(text)
    assert served["trace"] == out["trace"] and served["request"] == out["id"]
    got = [s["name"] for s in served["spans"]]
    # the router buffers its placement, the engine's finish (first, in
    # this process) flushes it with the engine's hops, the route last
    assert got == [spans.SPAN_PLACEMENT, spans.SPAN_QUEUE,
                   spans.SPAN_PREFILL, spans.SPAN_DECODE, spans.SPAN_ROUTE]


# ---------------------------------------------------------------- metrics
def _fill(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("bigdl_router_requests_total", "Routed\nrequests \\ ok",
                    labels=("outcome",))
    c.labels(outcome='sh"ed').inc(3)
    c.labels(outcome="ok").inc(2.5)
    reg.gauge("bigdl_router_retry_budget_tokens").set(float("nan"))
    reg.gauge("zz_foreign", "").set(float("-inf"))
    h = reg.histogram("bigdl_request_latency_seconds", "Latency",
                      labels=("engine", "kind"), buckets=(0.1, 1.0))
    child = h.labels(engine="lm", kind="e2e")
    child.observe(0.05, exemplar={"trace_id": "abc"})
    child.observe(0.5)
    child.observe(7.0, exemplar={"trace_id": 'q"x'})
    reg.histogram("bigdl_phase_seconds", labels=("phase",))
    return reg


def _no_ts(text):
    return re.sub(r"(# \{[^}]*\} \S+) \d+\.\d{3}$", r"\1", text,
                  flags=re.M)


def test_to_prometheus_equals_jax():
    """The same families, children, escapes, special values and
    exemplars: the same exposition text (exemplar timestamps aside), and
    it parses back the same through either reader."""
    t, j = _fill(tmetrics).to_prometheus(), _fill(jmetrics).to_prometheus()
    assert " # {" in t
    assert _no_ts(t) == _no_ts(j)
    tp, jp = tmetrics.parse_prometheus(t), jmetrics.parse_prometheus(t)
    for s in tp["samples"] + jp["samples"]:
        s.get("exemplar", {}).pop("ts", None)
    assert json.dumps(tp, sort_keys=True) == json.dumps(jp, sort_keys=True)
    assert tmetrics.sample_value(tp, "bigdl_router_requests_total",
                                 outcome="ok") == 2.5
    assert tmetrics.MetricsRegistry().to_prometheus() == ""
    with pytest.raises(ValueError, match="bad exposition line"):
        tmetrics.parse_prometheus("not a sample line at all")


def _strict_cases():
    return {
        "undeclared": lambda r: r.counter("bigdl_made_up_total"),
        "kind": lambda r: r.gauge("bigdl_router_shed_total"),
        "labels": lambda r: r.counter("bigdl_router_shed_total",
                                      labels=("why",)),
        "ceiling": lambda r: [r.counter(
            "bigdl_router_requests_total", labels=("outcome",)).labels(
            outcome=str(i)) for i in range(9)],
        "foreign": lambda r: r.counter("my_own_total", labels=("x",)),
        "declared": lambda r: r.counter("bigdl_router_shed_total"),
    }


@pytest.mark.parametrize("case", sorted(_strict_cases()))
@pytest.mark.parametrize("strict", [False, True])
def test_strict_mode_raises_where_jax_does(monkeypatch, case, strict):
    if strict:
        monkeypatch.setenv("BIGDL_TORCH_OBS_STRICT", "1")
        monkeypatch.setenv("BIGDL_OBS_STRICT", "1")
    outcome = []
    for mod in (tmetrics, jmetrics):
        try:
            _strict_cases()[case](mod.MetricsRegistry())
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e).split(" ")[0])
    assert outcome[0] == outcome[1]
    assert (outcome[0] is not None) == (
        strict and case in ("undeclared", "kind", "labels", "ceiling"))


def test_declarations_equal_jax():
    from bigdl_tpu.obs import names as jnames

    assert len(names.REGISTRY) >= 27
    # the port's own families are exactly those the JAX package lacks
    assert {n for n in names.REGISTRY if n not in jnames.REGISTRY} == \
        names.PORT_ONLY
    for name, spec in names.REGISTRY.items():
        if name in names.PORT_ONLY:
            continue
        j = jnames.REGISTRY[name]
        assert (spec.kind, spec.labels, spec.cardinality, spec.policy) == \
            (j.kind, j.labels, j.cardinality, j.policy), name
    assert names.is_declared("bigdl_request_latency_seconds_bucket")
    assert not names.is_declared("bigdl_router_shed_total_bucket")
    with pytest.raises(ValueError, match="duplicate"):
        names._m("bigdl_router_shed_total", "counter")
    with pytest.raises(ValueError, match="explicit fleet"):
        names._m("bigdl_new_gauge", "gauge")


# ---------------------------------------------------------- tracer, server
def test_tracer_files_ring_and_null(tmp_path, monkeypatch):
    assert obs.get_tracer() is obs.NULL_TRACER
    with obs.get_tracer().span("x"):
        pass
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("BIGDL_TORCH_FLIGHT_SPANS", "3")
    tr = obs.get_tracer()
    assert tr.enabled and obs.get_tracer() is tr and obs.active()
    with tr.span(spans.SPAN_STEP_DECODE, bucket=2) as sid:
        tr.event(spans.EVENT_ADMIT, slot=0)
    tr.complete(spans.SPAN_QUEUE, 0.0, 0.25, trace="t")
    tr.counter("rss", bytes=1)
    recent = tr.recent()
    assert [r["name"] for r in recent] == [
        spans.EVENT_ADMIT, spans.SPAN_STEP_DECODE, spans.SPAN_QUEUE]
    assert recent[0]["parent"] == sid and recent[2]["dur_s"] == 0.25
    tr.flush()
    doc = json.load(open(tr.trace_path))
    assert {e["name"] for e in doc["traceEvents"]} >= {
        "rss", spans.SPAN_QUEUE, spans.SPAN_STEP_DECODE}
    lines = open(tr.jsonl_path).read().splitlines()
    assert len(lines) == 3
    obs.reset()
    assert tr._closed


def test_obs_server_routes(tmp_path, monkeypatch, lms):
    """``/metrics`` parses and carries the engine's families and an
    exemplar; ``/healthz`` has JAX's keys, with the goodput ledger on
    (tracing is) and the alerts, profiler and bundles off;
    ``/trace?last=K`` reads the flight recorder; ``/trace?request=ID``
    finds a kept trace or answers 404; ``/profilez`` answers the off
    profiler's snapshot and ``/debugz`` 503 without a bundle
    directory."""
    _, tm = lms
    assert tserver.ensure_server() is None
    monkeypatch.setenv("BIGDL_TORCH_OBS_PORT", "0")
    monkeypatch.setenv("BIGDL_TORCH_OBS_PORT_FILE",
                       str(tmp_path / "port"))
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "tr"))
    monkeypatch.setenv("BIGDL_TORCH_REQTRACE_SAMPLE", "1.0")
    srv = tserver.ensure_server()
    assert srv is tserver.ensure_server() is tserver.get_server()
    assert open(tmp_path / "port").read() == str(srv.port)
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    req = eng.submit([3, 1, 4], 3)
    eng.run_until_idle(60)
    eng.close()
    extra = tmetrics.MetricsRegistry()
    extra.counter("private_total").inc()
    tserver.register_registry(extra)
    code, text = _get(srv.url("/metrics"))
    assert code == 200 and "private_total 1" in text
    parsed = tmetrics.parse_prometheus(text)
    fams = parsed["families"]
    assert fams[names.SERVE_TOKENS_TOTAL]["type"] == "counter"
    assert any("exemplar" in s for s in parsed["samples"])
    code, text = _get(srv.url("/healthz"))
    health = json.loads(text)
    # no trainer of the port stamps its steps yet: JAX's no-trainer body
    assert code == 200 and health["status"] == "idle"
    assert (health["step"], health["step_age_s"]) == (None, None)
    assert set(health) == set(jserver.health_payload())
    assert (health["goodput_ratio"], health["alerts"], health["heartbeat"],
            health["prof_overhead"], health["bundles"]) == (
        0.0, [], None, None, 0)
    code, text = _get(srv.url("/trace?last=2"))
    tail = json.loads(text)
    assert code == 200 and len(tail) == 2
    assert tail[-1]["name"] == spans.SPAN_STEP_DECODE or any(
        r["name"].startswith("req.") for r in tail)
    code, text = _get(srv.url(f"/trace?request={req.trace.trace_id}"))
    assert code == 200 and json.loads(text)["request"] == str(req.id)
    assert _get(srv.url("/trace?request=nope"))[0] == 404
    code, text = _get(srv.url("/profilez"))
    assert code == 200 and json.loads(text)["enabled"] is False
    code, text = _get(srv.url("/debugz"))
    body = json.loads(text)
    assert code == 503 and "BUNDLE_DIR" in body["error"]
    assert body["inventory"] == []
    code, text = _get(srv.url("/"))
    assert json.loads(text)["endpoints"][0] == "/metrics"
    assert _get(srv.url("/nope"))[0] == 404
    obs.reset()
    assert tserver.get_server() is None


def test_engine_replica_signals_and_undrain(lms):
    _, tm = lms
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                   weight_version="v9")
    rep = EngineReplica("e", eng)
    eng.submit([1, 2], 2)
    assert rep.signals() == {"up": True, "draining": False,
                             "queue_depth": 1.0, "kv_frac": 0.0,
                             "weight_version": "v9"}
    records = rep.drain(0.0)
    assert [hd.source for hd in records] == ["e"]
    assert rep.signals()["draining"]
    rep.undrain()
    assert not rep.signals()["draining"]
    eng.close()
