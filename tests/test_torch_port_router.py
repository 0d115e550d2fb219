"""The port's router tier (``RetryBudget``, ``PlacementPolicy``,
``Router``, ``EngineReplica``, ``HTTPReplica``, ``RouterServer``) and
the ``fused`` decode impl, against the JAX package on the CPU.

Both packages serve the same weights: a tiny ``TransformerLM`` (vocab
64, dim 32, 2 layers) from a numpy seed, carried across with
``load_jax_params``.  Limits: the budget's and the placement's state
and choices equal JAX's exactly on the same inputs and clock (a
hypothesis property); temperature-0 tokens through either router equal
exactly (the same f32 model, one request at a time); handoff records
equal exactly; the fused decode within 1e-5 of JAX ``_fused`` (f32 sums
in other orders).  Engines are pumped by hand or wait on conditions (a
queue depth, an event), never on a bare sleep; servers bind ephemeral
ports and close in ``finally``; both packages' telemetry is reset
around each test."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from bigdl_tpu import obs as jobs
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.ops import decode_attention as jdec
from bigdl_tpu.resilience.retry import RetryBudget as JBudget
from bigdl_tpu.serving import LMEngine as JEngine
from bigdl_tpu.serving import placement as jplace
from bigdl_tpu.serving import router as jrouter
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.ops import decode_attention as tdec
from bigdl_tpu_torch.resilience import RetryBudget
from bigdl_tpu_torch.serving import (EngineReplica, HandoffRecord,
                                     HTTPReplica, LMEngine,
                                     NoReplicaAvailable, PlacementPolicy,
                                     ReplicaUnavailable, ReplicaView, Router,
                                     RouterServer, RouterShed, ServingServer)
from bigdl_tpu_torch.utils.convert import load_jax_params

TINY = dict(dim=32, n_head=4, n_layer=2, max_len=64)
VOCAB = 64
FUSED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for var in ("BIGDL_TORCH_REQTRACE_SAMPLE", "BIGDL_TORCH_TRACE_DIR",
                "BIGDL_TORCH_OBS_PORT", "BIGDL_TORCH_OBS_STRICT",
                "BIGDL_REQTRACE_SAMPLE", "BIGDL_TRACE_DIR", "BIGDL_OBS_PORT"):
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
    """(JAX model, port model on its weights)."""
    JRandom.RNG.set_seed(21)
    jm = j_build(VOCAB, attn_impl="xla", **TINY)
    tm = t_build(VOCAB, attn_impl="reference", device="cpu", **TINY)
    load_jax_params(tm, _np(jm.params()))
    return jm, tm


def _ref(jm, prompt, n):
    return [int(t) for t in np.asarray(jm.generate(
        jm.params(), np.asarray(prompt)[None, :], n))[0]]


def _wait_for(pred, what, timeout=60.0):
    """Poll ``pred`` until it holds (a condition, with a deadline)."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _queued(eng):
    """Requests ready to take from an engine's queue (the JAX queue moves
    them into its buffer on a thread)."""
    return getattr(eng.queue, "_buf", eng.queue).depth()


def _counter(name):
    fams = {f.name: f for f in obs.get_registry().families()}
    fam = fams.get(name)
    return 0.0 if fam is None else sum(c.value for _, c in fam.child_items())


# ------------------------------------------------------------ retry budget
@settings(max_examples=60, deadline=None)
@given(ratio=st.floats(0.0, 2.0), burst=st.floats(0.0, 10.0),
       initial=st.one_of(st.none(), st.floats(0.0, 12.0)),
       ops=st.lists(st.tuples(st.booleans(), st.floats(0.1, 3.0)),
                    max_size=40))
def test_retry_budget_equals_jax(ratio, burst, initial, ops):
    """Deposits and spends in any order: the same grants, denials and
    tokens (exactly)."""
    t, j = RetryBudget(ratio, burst, initial), JBudget(ratio, burst, initial)
    for deposit, cost in ops:
        if deposit:
            t.record_request()
            j.record_request()
        else:
            assert t.try_spend(cost) == j.try_spend(cost)
        assert t.stats() == j.stats()


def test_retry_budget_rejects_a_negative_ratio():
    with pytest.raises(ValueError, match=">= 0"):
        RetryBudget(ratio=-0.1)


# --------------------------------------------------------------- placement
_view = st.builds(
    dict, up=st.booleans(), draining=st.booleans(), stale=st.booleans(),
    queue_depth=st.integers(0, 4).map(float), in_flight=st.integers(0, 3),
    kv_frac=st.sampled_from([0.0, 0.125, 0.25, 0.5, 1.0]),
    version=st.sampled_from([None, "v0", "v1"]))


@settings(max_examples=60, deadline=None)
@given(steps=st.lists(st.tuples(
    st.dictionaries(st.sampled_from(["a", "b", "c", "d"]), _view,
                    min_size=1, max_size=4),
    st.sampled_from([None, "s1", "s2"]),
    st.sets(st.sampled_from(["a", "b", "c", "d"]), max_size=2),
    st.floats(0.0, 200.0)), min_size=1, max_size=12),
    ttl=st.sampled_from([0.0, 150.0, 300.0]),
    kv_weight=st.sampled_from([0.0, 4.0]))
def test_placement_choose_equals_jax(steps, ttl, kv_weight):
    """The same view snapshots, sessions, exclusions and virtual clock:
    the same choices (or the same refusal), bindings and counts."""
    now = [0.0]
    t = PlacementPolicy(ttl, kv_weight, clock=lambda: now[0])
    j = jplace.PlacementPolicy(ttl, kv_weight, clock=lambda: now[0])
    for views, session, exclude, dt in steps:
        now[0] += dt
        tv = {n: ReplicaView(n, **v) for n, v in views.items()}
        jv = {n: jplace.ReplicaView(n, **v) for n, v in views.items()}
        try:
            want = j.choose(jv, session, exclude=set(exclude))
        except jplace.NoReplicaAvailable:
            with pytest.raises(NoReplicaAvailable):
                t.choose(tv, session, exclude=set(exclude))
        else:
            assert t.choose(tv, session, exclude=set(exclude)) == want
        assert t.stats() == j.stats()
        assert t.bindings() == j.bindings()
    for name in ("a", "b"):
        assert t.unbind_replica(name) == j.unbind_replica(name)


# ---------------------------------------------------- routing over engines
def _routers(lms, jkw=None, tkw=None, start=True):
    """A JAX router and a port router, each over two engines on the same
    weights."""
    jm, tm = lms
    je = [JEngine(jm, max_batch=2, page_size=8, **(jkw or {}))
          for _ in range(2)]
    te = [LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                   **(tkw or {})) for _ in range(2)]
    if start:
        for e in je + te:
            e.start()
    jr = jrouter.Router([jrouter.EngineReplica(f"r{i}", e)
                         for i, e in enumerate(je)],
                        request_timeout_s=120.0, sleep=lambda s: None)
    tr = Router([EngineReplica(f"r{i}", e) for i, e in enumerate(te)],
                request_timeout_s=120.0, sleep=lambda s: None)
    return jr, tr, je + te


@pytest.mark.parametrize("decode_attn", ["dense", "fused", "kernel"])
def test_router_tokens_equal_jax_router(lms, decode_attn):
    """Temperature-0 requests, two of one session: the port's router
    places and answers as JAX's does (its ``kernel`` decode runs the
    plain paged decode on the CPU, JAX the dense one)."""
    jattn = "dense" if decode_attn == "kernel" else decode_attn
    jr, tr, engines = _routers(lms, {"decode_attn": jattn},
                               {"decode_attn": decode_attn})
    rs = np.random.RandomState(2)
    try:
        for n_p, n_new, session in ((5, 8, "t0"), (9, 4, "t0"),
                                    (4, 6, None)):
            p = rs.randint(0, VOCAB, (n_p,)).tolist()
            want, got = jr.route(p, n_new, session=session), \
                tr.route(p, n_new, session=session)
            assert got["tokens"] == [int(t) for t in want["tokens"]]
            assert (got["replica"], got["retries"], got["handoffs"]) == \
                (want["replica"], want["retries"], want["handoffs"])
        assert tr.placement.stats() == jr.placement.stats()
        assert tr.ledger.stats() == jr.ledger.stats()
        assert _counter(names.ROUTER_AFFINITY_HITS_TOTAL) == 1
        assert tr.stats()["budget"] == jr.stats()["budget"]
    finally:
        for e in engines:
            e.close()


class _DrainOnSubmit:
    """A replica wrapper whose ``generate`` drains its engine (deadline 0)
    as soon as the request sits in the queue, before any decode: the
    queued-before-decode handoff, waited for on the queue's depth."""

    def __init__(self, replica):
        self.replica = replica
        self.name = replica.name
        self.records = []

    def __getattr__(self, attr):
        return getattr(self.replica, attr)

    def generate(self, prompt, max_new_tokens, **kw):
        eng = self.replica.engine

        def drain():
            _wait_for(lambda: _queued(eng) == 1, "the queued request")
            self.records.extend(self.replica.drain(0.0))

        t = threading.Thread(target=drain)
        t.start()
        try:
            return self.replica.generate(prompt, max_new_tokens, **kw)
        finally:
            t.join(timeout=60)


def test_queued_before_decode_handoff_replays_like_jax(lms):
    """Drained while still queued: the record carries no token, the
    router replays the request once on the other replica, and the
    tokens, records and ledgers equal JAX's."""
    jm, tm = lms
    p = [1, 2, 3, 4]
    out, recs = {}, {}
    for pkg, mod, eng_cls, model, kw in (
            ("jax", jrouter, JEngine, jm, {}),
            ("port", None, LMEngine, tm, {"device": "cpu"})):
        a = eng_cls(model, max_batch=2, page_size=8, **kw)
        b = eng_cls(model, max_batch=2, page_size=8, **kw).start()
        rep = (jrouter.EngineReplica if pkg == "jax" else EngineReplica)
        ra = _DrainOnSubmit(rep("a", a))
        r_cls = jrouter.Router if pkg == "jax" else Router
        r = r_cls([ra, rep("b", b)], request_timeout_s=120.0,
                  sleep=lambda s: None)
        try:
            out[pkg] = r.route(p, 6, request_id="q1")
            recs[pkg] = [hd.to_dict() for hd in ra.records]
            out[pkg]["ledger"] = r.ledger.stats()
        finally:
            a.close()
            b.close()
    assert recs["port"] == recs["jax"]
    assert recs["port"][0]["tokens_done"] == []
    assert recs["port"][0]["prompt"] == p
    for key in ("tokens", "replica", "handoffs", "retries", "ledger"):
        assert out["port"][key] == out["jax"][key], key
    assert p + out["port"]["tokens"] == _ref(jm, p, 6)
    assert _counter(names.ROUTER_HANDOFFS_TOTAL) == 1


def test_mid_decode_drain_records_and_replays_equal_jax(lms):
    """Three requests on two slots, two steps pumped by hand, a drain at
    deadline 0: the records (prompt refolds, tokens done, owed) equal
    JAX's, and replaying each once on a second engine completes every
    request with JAX's tokens."""
    jm, tm = lms
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, (n,)).tolist() for n in (5, 9, 3)]
    got = {}
    for pkg, eng_cls, model, kw in (("jax", JEngine, jm, {}),
                                    ("port", LMEngine, tm,
                                     {"device": "cpu"})):
        eng = eng_cls(model, max_batch=2, page_size=8, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        for i, r in enumerate(reqs):
            r.router_id = f"q{i}"
        _wait_for(lambda: _queued(eng) == len(prompts), "the queue")
        eng.pump()
        eng.pump()
        records = eng.drain(0.0)
        eng.close()
        dst = eng_cls(model, max_batch=2, page_size=8, **kw)
        full = {}
        for hd in records:
            r = dst.submit(hd.prompt, hd.max_new_tokens)
            dst.run_until_idle(60)
            full[hd.request_id] = [int(t) for t in hd.tokens_done
                                   + r.tokens]
        dst.close()
        got[pkg] = ([hd.to_dict() for hd in records], full)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == len(prompts)
    for i, p in enumerate(prompts):
        assert p + got["port"][1][f"q{i}"] == _ref(jm, p, 6)


def test_version_pinned_handoff_refuses_other_version(lms):
    """A handoff decoded under vA is refused by the cheapest survivor,
    which serves vB (counted), and lands on the vA replica."""
    jm, tm = lms
    other = t_build(VOCAB, attn_impl="reference", device="cpu", **TINY)
    ea = LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                  weight_version="vA")
    eb = LMEngine(other, max_batch=2, page_size=8, device="cpu",
                  weight_version="vB").start()
    ec = LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                  weight_version="vA").start()
    ra = _DrainOnSubmit(EngineReplica("a", ea))
    router = Router([ra, EngineReplica("b", eb), EngineReplica("c", ec)],
                    request_timeout_s=120.0, sleep=lambda s: None)
    p = [5, 11, 2, 7, 3, 9]
    try:
        res = router.route(p, 8)
    finally:
        for e in (ea, eb, ec):
            e.close()
    assert ra.records[0].weight_version == "vA"
    assert res["replica"] == "c" and res["handoffs"] == 1
    assert p + res["tokens"] == _ref(jm, p, 8)
    assert _counter(names.ROLLOUT_VERSION_MISMATCH_TOTAL) == 1


# --------------------------------------------------------------- HTTP tier
def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class _Dead:
    """A replica whose every call fails transiently."""

    def __init__(self, name, exc_type):
        self.name = name
        self._exc = exc_type

    def generate(self, prompt, max_new_tokens, **kw):
        raise self._exc(f"{self.name}: down")

    def signals(self):
        return {"up": True, "draining": False, "queue_depth": 0.0,
                "kv_frac": 0.0}

    def drain(self, deadline_s=10.0):
        return []


def test_router_server_sheds_503_with_retry_after_like_jax():
    """An empty budget over failing replicas: both front ends answer 503
    with the same Retry-After and body; the shed and request counters
    count it."""
    answers = {}
    for pkg, r_cls, s_cls, exc in (
            ("jax", jrouter.Router, jrouter.RouterServer,
             jrouter.ReplicaUnavailable),
            ("port", Router, RouterServer, ReplicaUnavailable)):
        router = r_cls([_Dead("a", exc), _Dead("b", exc)],
                       retry_budget_ratio=0.0, retry_budget_burst=0.0,
                       retry_after_s=2.6, sleep=lambda s: None)
        front = s_cls(router, port=0)
        try:
            answers[pkg] = _post(front.url("/v1/generate"),
                                 {"prompt": [1, 2], "max_new_tokens": 2})
            answers[pkg + "_missing"] = _post(front.url("/v1/generate"),
                                              {"max_new_tokens": 2})
            answers[pkg + "_404"] = _post(front.url("/nope"), {})
        finally:
            front.close()
    for suffix in ("", "_missing", "_404"):
        (tc, th, tb), (jc, jh, jb) = answers["port" + suffix], \
            answers["jax" + suffix]
        assert (tc, tb) == (jc, jb), suffix
    code, headers, body = answers["port"]
    assert code == 503 and headers["Retry-After"] == "3"
    assert body["retry_budget"]["retries_denied"] == 1
    assert _counter(names.ROUTER_SHED_TOTAL) == 1
    assert answers["port_missing"][0] == 400


def test_http_replica_over_the_port_serving_server(lms):
    """``HTTPReplica`` against the port's ``ServingServer``: tokens equal
    JAX's generate, the signals read ``/stats``, a drain over
    ``/admin/drain`` returns records, and a request the drain
    checkpointed comes back as ``ReplicaDraining``."""
    jm, tm = lms
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                   weight_version="v3").start()
    srv = ServingServer(lm=eng, port=0)
    router = Router([HTTPReplica("h", srv.url(""))],
                    request_timeout_s=60.0)
    front = RouterServer(router, port=0)
    p = [4, 8, 15, 16, 23]
    try:
        code, _, out = _post(front.url("/v1/generate"),
                             {"prompt": p, "max_new_tokens": 6,
                              "session": "h1"})
        sig = router.replicas["h"].signals()
        health = json.loads(urllib.request.urlopen(
            front.url("/healthz"), timeout=30).read())
        stats = json.loads(urllib.request.urlopen(
            front.url("/stats"), timeout=30).read())
        summary = router.begin_drain("h", deadline_s=0.0)
    finally:
        front.close()
        srv.close()
        eng.close()
    assert code == 200 and p + out["tokens"] == _ref(jm, p, 6)
    assert out["replica"] == "h" and out["retries"] == 0
    assert sig == {"up": True, "draining": False, "queue_depth": 0.0,
                   "kv_frac": 0.0, "weight_version": "v3"}
    assert health == {"status": "ok", "replicas": {"h": "up"},
                      "weight_versions": {"h": "v3"}}
    assert stats["replicas"]["h"]["weight_version"] == "v3"
    assert summary == {"replica": "h", "handoffs": 0, "router_owned": 0,
                       "orphans": [], "sessions_unbound": 1}


def test_http_replica_maps_a_handoff_answer_and_errors():
    """The fetch seam: a 503 with a handoff raises ``ReplicaDraining``
    carrying the record, a 503 without one ``ReplicaUnavailable``, a
    400 ``ValueError``; a trace context rides as the header."""
    from bigdl_tpu_torch.obs.reqtrace import (TRACE_HEADER,
                                              RequestTraceContext)
    from bigdl_tpu_torch.serving import ReplicaDraining

    seen = []
    hd = HandoffRecord(prompt=[1, 2, 9], max_new_tokens=3,
                       tokens_done=[9], weight_version="v1")
    script = [(503, {"handoff": hd.to_dict()}), (503, {"error": "full"}),
              (400, {"error": "bad"})]

    def fetch(url, body=None, timeout_s=30.0, headers=None):
        seen.append((url, body, headers))
        return script.pop(0)

    rep = HTTPReplica("x", "127.0.0.1:1", fetch=fetch)
    with pytest.raises(ReplicaDraining) as ei:
        rep.generate([1, 2], 4, request_id="q",
                     trace=RequestTraceContext("tid", keep=True))
    assert ei.value.handoff.tokens_done == [9]
    assert ei.value.handoff.request_id == "q"
    assert ei.value.handoff.source == "x"
    assert seen[0][2] == {TRACE_HEADER: "tid::k"}
    with pytest.raises(ReplicaUnavailable):
        rep.generate([1], 1)
    with pytest.raises(ValueError):
        rep.generate([1], 1)
    assert seen[0][0] == "http://127.0.0.1:1/v1/generate"


# ------------------------------------------------------------- fused decode
@pytest.mark.parametrize("block_pages", [0, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decode_equals_jax_fused(block_pages, dtype):
    """``impl="fused"`` against JAX ``_fused`` on the same pools,
    tables (6 columns: 2 and 3 divide it, 0 is one block) and lengths,
    one slot at 0; within 1e-5 of the largest |o| (f32 accumulation in
    both; bf16 inputs are read exactly)."""
    rs = np.random.RandomState(block_pages)
    b, h, d, p, maxp, pages = 4, 2, 16, 8, 6, 20
    q = rs.randn(b, h, d).astype(np.float32)
    kp = rs.randn(pages, h, p, d).astype(np.float32)
    vp = rs.randn(pages, h, p, d).astype(np.float32)
    tables = rs.randint(1, pages, (b, maxp)).astype(np.int32)
    lengths = np.array([0, 7, 23, 47], np.int32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kp, vp))
    got = tdec.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
        page_size=p, impl="fused", block_pages=block_pages)
    jq, jk, jv = (jax.numpy.asarray(t.float().numpy()).astype(dtype)
                  for t in (tq, tk, tv))
    want = np.asarray(jdec.paged_decode_attention(
        jq, jk, jv, tables, lengths, page_size=p, impl="fused",
        block_pages=block_pages)).astype(np.float32)
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want).max()
    scale = np.abs(want).max()
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    assert err <= FUSED_TOL * scale + ulp * scale
    dense = tdec.paged_decode_attention(
        tq.float(), tk.float(), tv.float(), torch.from_numpy(tables),
        torch.from_numpy(lengths), page_size=p, impl="dense")
    if dtype == "float32":
        assert (got - dense).abs().max().item() <= FUSED_TOL * scale


def test_chunk_pages_equals_jax():
    for maxp in range(1, 13):
        for bp in range(0, 14):
            assert tdec._chunk_pages(maxp, bp) == jdec._chunk_pages(maxp, bp)


def test_engine_rejects_an_unknown_decode_attn(lms):
    _, tm = lms
    with pytest.raises(ValueError, match="auto\\|dense\\|fused\\|kernel"):
        LMEngine(tm, decode_attn="pallas", device="cpu")


def test_router_sheds_when_nothing_is_eligible(lms):
    router = Router([], sleep=lambda s: None)
    with pytest.raises(RouterShed, match="no eligible replica"):
        router.route([1], 1)
    assert _counter(names.ROUTER_SHED_TOTAL) == 1
    assert _counter(names.ROUTER_REQUESTS_TOTAL) == 1


def test_max_retries_shed_counts_failed_and_shed_like_jax():
    """A request that runs out of attempts is counted twice in
    ``bigdl_router_requests_total`` (``failed``, then ``shed`` by the
    shed path), in both packages: a copied hazard (ROADMAP.md queue 3)."""
    counts = {}
    for pkg, r_cls, exc, reg in (
            ("jax", jrouter.Router, jrouter.ReplicaUnavailable,
             jobs.get_registry),
            ("port", Router, ReplicaUnavailable, obs.get_registry)):
        router = r_cls([_Dead("a", exc), _Dead("b", exc)], max_retries=1,
                       sleep=lambda s: None)
        with pytest.raises(Exception, match="2 attempts failed"):
            router.route([1], 1)
        fam = {f.name: f for f in reg().families()}[
            names.ROUTER_REQUESTS_TOTAL]
        counts[pkg] = {k[0]: c.value for k, c in fam.child_items()}
    assert counts["port"] == counts["jax"] == {"failed": 1.0, "shed": 1.0}


def test_pinned_handoff_with_no_version_exact_replica_is_shed_like_jax(lms):
    """A handoff pinned to a version no other replica serves (a canary
    drained at deadline 0 during a rollback) is refused by every
    survivor and shed, in both packages: a copied hazard (ROADMAP.md
    queue 3); a rollback that drops nothing needs a drain deadline its
    in-flight requests finish inside."""
    jm, tm = lms
    seen = {}
    for pkg, r_mod, eng_cls, model, kw, reg in (
            ("jax", jrouter, JEngine, jm, {}, jobs.get_registry),
            ("port", None, LMEngine, tm, {"device": "cpu"},
             obs.get_registry)):
        rep = jrouter.EngineReplica if pkg == "jax" else EngineReplica
        r_cls = jrouter.Router if pkg == "jax" else Router
        engines = [eng_cls(model, max_batch=2, page_size=8,
                           weight_version=v, **kw) for v in ("v3", "v1",
                                                              "v1")]
        canary = _DrainOnSubmit(rep("a", engines[0]))
        router = r_cls([canary, rep("b", engines[1]), rep("c", engines[2])],
                       request_timeout_s=120.0, sleep=lambda s: None)
        try:
            with pytest.raises(Exception, match="no eligible replica"):
                router.route([1, 2, 3], 4)
        finally:
            for e in engines:
                e.close()
        fams = {f.name: f for f in reg().families()}
        seen[pkg] = (
            canary.records[0].weight_version,
            fams[names.ROLLOUT_VERSION_MISMATCH_TOTAL]._solo().value,
            {k[0]: c.value for k, c in
             fams[names.ROUTER_REQUESTS_TOTAL].child_items()})
    assert seen["port"] == seen["jax"] == ("v3", 2.0, {"shed": 1.0})
