"""The port's serving front (``ServingServer``, ``ClassifierEngine``,
drain and handoff, ``swap_weights``, int8 decode) against the JAX
package, on the CPU.

Both packages serve the same weights (a tiny ``TransformerLM``, a small
MLP and a small conv net, from numpy seeds through ``load_jax_params``).
Limits: temperature-0 tokens equal JAX's engine's (float, int8, after a
swap); classifier outputs within 1e-5 of JAX's (float: the same f32
GEMMs summed in other orders) and within 1e-6 (int8: the same int32
sums); handoff records equal JAX's.  Engines are pumped by hand, a
drain runs at a fixed pump step with ``deadline_s=0``, servers bind
ephemeral ports and close in ``finally``; no assert reads a clock."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_build
from bigdl_tpu.serving import ClassifierEngine as JClassifier
from bigdl_tpu.serving import LMEngine as JEngine
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_build
from bigdl_tpu_torch.nn.quantized import QuantizedLinear
from bigdl_tpu_torch.obs import names, reqtrace
from bigdl_tpu_torch.serving import (HANDOFF_ERROR, ClassifierEngine,
                                     HandoffLedger, HandoffRecord, LMEngine,
                                     ServingServer)
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

SMALL = dict(dim=32, n_head=4, n_layer=2, max_len=64)
VOCAB = 48
CLS_F32_TOL, CLS_INT8_TOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lm(seed):
    JRandom.RNG.set_seed(seed)
    return j_build(VOCAB, attn_impl="xla", **SMALL)


@pytest.fixture(scope="module")
def lms():
    """(JAX model, its params, port model on the same weights) for
    seed 13, and the params of a second model (seed 14)."""
    jm = _jax_lm(13)
    tm = t_build(VOCAB, attn_impl="kernel", device="cpu", **SMALL)
    load_jax_params(tm, _np(jm.params()))
    other = _np(_jax_lm(14).params())
    return jm, tm, other


def _port_lm(lms, params=None):
    """A fresh port model with the seed-13 weights (or ``params``)."""
    jm, _, _ = lms
    tm = t_build(VOCAB, attn_impl="kernel", device="cpu", **SMALL)
    load_jax_params(tm, params if params is not None else _np(jm.params()))
    return tm


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)) for n in lens]


def _wait_queued(eng, n):
    """Wait until ``n`` requests are ready to take from the engine's
    queue.  The JAX package's queue moves each one from a backlog into
    its buffer on a thread, and a ``take`` that finds the buffer empty
    gives up after 0.1-20 ms: a pump (or a drain) would then take fewer
    requests, and the batches and step counts would depend on thread
    timing.  So for JAX's queue this waits for its buffer to hold all
    ``n``."""
    ready = getattr(eng.queue, "_buf", eng.queue).depth
    deadline = time.monotonic() + 60
    while ready() < n and time.monotonic() < deadline:
        time.sleep(0.001)
    assert ready() == n


def _serve(eng, prompts, n_new):
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.run_until_idle(120)
    assert all(r.error is None for r in reqs)
    return [[int(t) for t in r.tokens] for r in reqs]


# ---------------------------------------------------------------- LM
def test_int8_engine_tokens_equal_jax_int8_engine(lms):
    jm, _, _ = lms
    tm = _port_lm(lms)
    prompts = _prompts(7, (5, 9, 12))
    je = JEngine(jm, max_batch=2, page_size=8, int8=True)
    te = LMEngine(tm, max_batch=2, page_size=8, int8=True,
                  decode_attn="kernel", device="cpu")
    try:
        want = _serve(je, prompts, 8)
        got = _serve(te, prompts, 8)
    finally:
        je.close()
        te.close()
    assert got == want
    q = te._qparams["h0"]["attn"]["wq"]
    jq = je._qparams["h0"]["attn"]["wq"]
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(jq[0]))
    st = te.stats()
    assert st["int8"] is True
    # int8 streams the 1-byte twins: every >= 2-D weight at one byte
    f32 = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    assert te._weight_bytes < f32._weight_bytes / 3
    f32.close()


def test_swap_weights_tokens_equal_jax_after_the_same_swap(lms):
    jm, _, other = lms
    tm = _port_lm(lms)
    je = JEngine(jm, jm.params(), max_batch=2, page_size=8)
    te = LMEngine(tm, max_batch=2, page_size=8, decode_attn="kernel",
                  device="cpu")
    try:
        first = _prompts(8, (6,))
        assert _serve(te, first, 4) == _serve(je, first, 4)
        je.swap_weights(jax.tree.map(np.asarray, other), version="v1",
                        manifest_sha="abc")
        te.swap_weights(other, version="v1", manifest_sha="abc")
        after = _prompts(9, (5, 11))
        got, want = _serve(te, after, 8), _serve(je, after, 8)
    finally:
        je.close()
        te.close()
    assert got == want
    st = te.stats()
    assert (st["weight_version"], st["manifest_sha"], st["weight_swaps"]) \
        == ("v1", "abc", 1)
    # the model now holds the new weights, and a port state dict swaps
    np.testing.assert_array_equal(tm.head.weight.detach().numpy(),
                                  other["head"]["weight"])
    te2 = LMEngine(_port_lm(lms), max_batch=2, page_size=8, device="cpu")
    te2.swap_weights(tm.state_dict(), version="v2")
    assert torch.equal(te2.model.head.weight, tm.head.weight)
    with pytest.raises(KeyError, match="lacks wpe"):
        te2.swap_weights({"wte": other["wte"]}, version="v3")
    te2.close()


def test_int8_swap_requantizes(lms):
    _, _, other = lms
    te = LMEngine(_port_lm(lms), max_batch=2, page_size=8, int8=True,
                  device="cpu")
    before = te._qparams["head"][0].clone()
    te.swap_weights(other, version="v1")
    want = _port_lm(lms, other)
    ref = LMEngine(want, max_batch=2, page_size=8, int8=True, device="cpu")
    assert not torch.equal(before, te._qparams["head"][0])
    assert torch.equal(te._qparams["head"][0], ref._qparams["head"][0])
    p = _prompts(10, (7,))
    assert _serve(te, p, 6) == _serve(ref, p, 6)
    te.close()
    ref.close()


def _records(eng, prompts, pumps, n_new):
    for p in prompts:
        eng.submit(p, n_new)
    _wait_queued(eng, len(prompts))
    for _ in range(pumps):
        eng.pump()
    return eng.drain(deadline_s=0)


def test_drain_records_equal_jax_drain_records(lms):
    """Three requests on two slots, drained after three pump steps:
    two in flight are preempted (youngest first) and one still queued;
    the port's records equal JAX's ``drain_engine`` records."""
    jm, _, _ = lms
    prompts = _prompts(11, (5, 9, 4))
    je = JEngine(jm, max_batch=2, page_size=8)
    te = LMEngine(_port_lm(lms), max_batch=2, page_size=8,
                  decode_attn="kernel", device="cpu")
    try:
        want = _records(je, prompts, 3, 10)
        got = _records(te, prompts, 3, 10)
    finally:
        je.close()
        te.close()
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert len(got) == 3 and all(r.tokens_done for r in got[:2])
    assert te.stats()["draining"] is True
    with pytest.raises(RuntimeError, match="draining"):
        te.submit([1, 2], 3)
    rec = HandoffRecord.from_dict(json.loads(json.dumps(got[0].to_dict())))
    assert rec == got[0]


def test_replay_delivers_each_request_once_with_uninterrupted_tokens(lms):
    _, tm, _ = lms
    prompts = _prompts(12, (5, 9, 4, 7))
    n_new = 10
    ref = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    want = _serve(ref, prompts, n_new)
    ref.close()
    src = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    reqs = [src.submit(p, n_new) for p in prompts]
    for i, r in enumerate(reqs):
        r.router_id = f"r{i}"
    for _ in range(4):
        src.pump()
    done_before = {r.router_id: r.tokens for r in reqs if r.done}
    records = src.drain(deadline_s=0)
    assert all(r.done for r in reqs)
    assert {r.error for r in reqs if r.router_id not in done_before} \
        == {HANDOFF_ERROR}
    ledger = HandoffLedger()
    for rid in done_before:
        assert ledger.deliver(rid)
    dst = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    out = dict(done_before)
    for rec in records:
        assert ledger.claim(rec.request_id)
        assert not ledger.claim(rec.request_id)       # a second path
        r = dst.submit(rec.prompt, rec.max_new_tokens,
                       temperature=rec.temperature)
        dst.run_until_idle(60)
        assert ledger.deliver(rec.request_id)
        out[rec.request_id] = rec.tokens_done + r.tokens
    dst.close()
    assert not ledger.deliver("r0") and ledger.duplicates == 1
    assert ledger.stats()["delivered"] == len(prompts)
    assert [out[f"r{i}"] for i in range(len(prompts))] == want


def test_locked_gets_in_between_two_steps_of_a_busy_loop(lms):
    """The engine's own loop takes its lock again as soon as a step
    lets go of it; while a caller waits in ``LMEngine.locked()`` (a
    drain, a swap), the loop starts at most the one step it had already
    decided on, then stands aside (a loop that does not started up to
    25 here).  Steps are a stub that holds the lock 2 ms and always has
    work; eight spinning threads load the interpreter as HTTP handlers
    do."""
    _, tm, _ = lms
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    started_while_waiting = [0]

    def busy_step(wait_s=0.0):
        with eng._lock:
            if eng._waiters:
                started_while_waiting[0] += 1
            time.sleep(0.002)
            return True

    eng.pump = busy_step
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))

    spinners = [threading.Thread(target=spin, daemon=True)
                for _ in range(8)]
    for t in spinners:
        t.start()
    eng.start()
    waited = []
    try:
        for _ in range(20):
            started_while_waiting[0] = 0
            with eng.locked():
                waited.append(started_while_waiting[0])
            time.sleep(0.003)
    finally:
        stop.set()
        eng.close()
        for t in spinners:
            t.join(timeout=10)
    assert max(waited) <= 1, waited


def test_drain_of_a_running_engine_hands_off(lms):
    _, tm, _ = lms
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu").start()
    try:
        reqs = [eng.submit(p, 50) for p in _prompts(15, (5, 6, 7, 8))]
        while not any(r.tokens for r in reqs):
            time.sleep(0.001)
        records = eng.drain(deadline_s=0)
    finally:
        eng.close()
    assert records and all(r.done for r in reqs)
    assert sum(r.error == HANDOFF_ERROR for r in reqs) == len(records)


# -------------------------------------------------------- classifier
def _mlp(P, L):
    return P.Sequential().add(L.Linear(16, 32)).add(L.ReLU()) \
        .add(L.Linear(32, 4)).add(L.LogSoftMax())


def _convnet(P, L):
    return P.Sequential() \
        .add(L.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1)) \
        .add(L.SpatialBatchNormalization(8)).add(L.ReLU()) \
        .add(L.SpatialConvolution(8, 4, 1, 1, 2, 2)) \
        .add(L.Reshape([4 * 4 * 4])).add(L.Linear(64, 5))


def _classifier_pair(build, int8, x):
    JRandom.RNG.set_seed(7)
    jm = build(JN, JN)
    tm = build(TN, TN)
    load_jax_params(tm, _np(jm.params()))
    load_jax_state(tm, _np(jm.state()))
    je = JClassifier(jm, max_batch=4, int8=int8, batch_window_s=0.0)
    te = ClassifierEngine(tm, max_batch=4, int8=int8, batch_window_s=0.0,
                          device="cpu")
    out = []
    for eng in (je, te):
        reqs = [eng.submit(row) for row in x]
        _wait_queued(eng, len(reqs))
        while any(not r.done for r in reqs):
            eng.pump(wait_s=0.05)
        assert all(r.error is None for r in reqs)
        out.append(np.stack([np.asarray(r.result) for r in reqs]))
        eng.close()
    return te, out[0], out[1]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("build,shape", [(_mlp, (6, 16)),
                                         (_convnet, (5, 3, 8, 8))])
def test_classifier_engine_matches_jax(int8, build, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    te, want, got = _classifier_pair(build, int8, x)
    tol = CLS_INT8_TOL if int8 else CLS_F32_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    st = te.stats()
    assert st["requests"] == shape[0] and st["batches"] == 2
    assert st["int8"] is int8
    if int8 and build is _mlp:
        assert any(isinstance(m, QuantizedLinear) for m in te.module.modules)


def test_classifier_batch_fault_fails_its_requests():
    JRandom.RNG.set_seed(7)
    eng = ClassifierEngine(_mlp(TN, TN), max_batch=2, batch_window_s=0.0,
                           device="cpu")
    bad = eng.submit(np.zeros(5, np.float32))      # 5 features, not 16
    eng.pump(wait_s=0.05)
    assert bad.done and "RuntimeError" in bad.error
    good = eng.submit(np.zeros(16, np.float32))
    eng.pump(wait_s=0.05)
    assert good.error is None and good.result.shape == (4,)
    eng.close()


def test_new_entry_points_need_the_card_unless_cpu_is_asked(lms):
    _, tm, _ = lms
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClassifierEngine(_mlp(TN, TN))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMEngine(tm, int8=True)


# --------------------------------------------------------------- HTTP
def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_server_round_trip_health_and_errors(lms):
    jm, tm, _ = lms
    JRandom.RNG.set_seed(7)
    lm = LMEngine(tm, max_batch=2, page_size=8, device="cpu",
                  weight_version="v7").start()
    clf = ClassifierEngine(_mlp(TN, TN), max_batch=2,
                           device="cpu").start()
    srv = ServingServer(lm=lm, classifier=clf, port=0)
    try:
        assert srv.port > 0
        prompt = [1, 2, 3]
        code, _, g = _post(srv.url("/v1/generate"),
                           {"prompt": prompt, "max_new_tokens": 4})
        assert code == 200 and g["prompt_len"] == 3 and g["e2e_s"] > 0
        want = np.asarray(jm.generate(jm.params(),
                                      np.asarray(prompt)[None], 4))[0]
        assert g["tokens"] == [int(t) for t in want[3:]]
        code, _, c = _post(srv.url("/v1/classify"),
                           {"inputs": np.zeros((2, 16)).tolist()})
        assert code == 200 and len(c["classes"]) == 2
        assert np.asarray(c["outputs"]).shape == (2, 4)
        st = _get(srv.url("/stats"))
        assert st["lm"]["requests"] >= 1 and st["classifier"]["requests"] >= 2
        h = _get(srv.url("/healthz"))
        assert h == {"status": "ok", "weight_version": "v7",
                     "manifest_sha": None}
        for bad in ({"prompt": []}, {"max_new_tokens": 3},
                    {"prompt": [1], "max_new_tokens": 999}):
            code, _, body = _post(srv.url("/v1/generate"), bad)
            assert code == 400, (bad, body)
        code, _, _ = _post(srv.url("/v1/nothing"), {})
        assert code == 404
    finally:
        srv.close()
        lm.close()
        clf.close()


def test_server_sheds_a_full_queue_and_a_draining_engine(lms):
    _, tm, _ = lms
    rejects = obs.get_registry().counter(names.SERVE_REJECTS_TOTAL)
    n0 = rejects._solo().value
    lm = LMEngine(tm, max_batch=2, page_size=8, queue_capacity=1,
                  device="cpu")                 # never pumped
    srv = ServingServer(lm=lm, port=0, request_timeout_s=0.2)
    try:
        lm.submit([1, 2, 3], 4)                 # fills the queue
        code, headers, body = _post(srv.url("/v1/generate"),
                                    {"prompt": [4, 5], "max_new_tokens": 3})
        assert code == 503 and headers["Retry-After"] == "1"
        assert body["error"].startswith("overloaded")
        assert body["engine"] == {"queue_depth": 1, "draining": False}
        code, _, d = _post(srv.url("/admin/drain"), {"deadline_s": 0})
        assert code == 200 and d["draining"] and len(d["handoffs"]) == 1
        code, headers, body = _post(srv.url("/v1/generate"),
                                    {"prompt": [4, 5], "max_new_tokens": 3})
        assert code == 503 and "draining" in body["error"]
        assert headers["Retry-After"] == "1"
        assert rejects._solo().value == n0 + 2
    finally:
        srv.close()
        lm.close()


def test_http_drain_hands_off_in_flight_requests(lms):
    """Four clients in flight on two slots; the engine is pumped by
    hand for three steps, then /admin/drain with deadline 0: each
    client gets a 503 whose handoff equals the drain's record, carrying
    its trace header; replays complete every request once with the
    uninterrupted run's tokens."""
    _, tm, _ = lms
    prompts = _prompts(13, (5, 9, 4, 7))
    n_new = 8
    ref = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    want = _serve(ref, prompts, n_new)
    ref.close()
    lm = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    srv = ServingServer(lm=lm, port=0)
    answers = {}

    def client(i):
        trace = reqtrace.RequestTraceContext(f"t{i}", parent=i).to_header()
        answers[i] = _post(srv.url("/v1/generate"),
                           {"prompt": prompts[i].tolist(),
                            "max_new_tokens": n_new,
                            "request_id": f"r{i}"},
                           headers={reqtrace.TRACE_HEADER: trace})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while lm.queue.depth() < len(prompts) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert lm.queue.depth() == len(prompts)
        for _ in range(3):
            lm.pump()
        code, _, d = _post(srv.url("/admin/drain"), {"deadline_s": 0})
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.close()
        lm.close()
    assert code == 200
    records = {r["request_id"]: r for r in d["handoffs"]}
    assert sorted(records) == [f"r{i}" for i in range(len(prompts))]
    dst = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    ledger = HandoffLedger()
    for i in range(len(prompts)):
        status, headers, body = answers[i]
        assert status == 503 and headers["Retry-After"] == "1"
        rec = HandoffRecord.from_dict(body["handoff"])
        assert rec == HandoffRecord.from_dict(records[f"r{i}"])
        assert rec.trace == f"t{i}:{i}:"
        assert rec.weight_version == "v0"
        assert ledger.claim(rec.request_id)
        r = dst.submit(rec.prompt, rec.max_new_tokens)
        dst.run_until_idle(60)
        assert ledger.deliver(rec.request_id)
        assert rec.tokens_done + r.tokens == want[i]
    dst.close()
    assert ledger.stats() == {"claimed": 4, "delivered": 4, "duplicates": 0}


def test_metric_families_match_the_jax_declarations(lms):
    """Every family the port's engines and server mint carries the JAX
    package's declared name, kind and label names."""
    from bigdl_tpu.obs import names as jnames

    _, tm, _ = lms
    eng = LMEngine(tm, max_batch=2, page_size=8, device="cpu")
    _serve(eng, _prompts(14, (4,)), 2)
    eng.close()
    ServingServer(port=0).close()
    ClassifierEngine(_mlp(TN, TN), device="cpu").close()
    fams = {f.name: f for f in obs.get_registry().families()}
    for const in names.__all__:
        name = getattr(names, const)
        assert name == getattr(jnames, const)
        spec, fam = jnames.REGISTRY[name], fams[name]
        assert (fam.kind, set(fam.labelnames)) == (spec.kind,
                                                   set(spec.labels)), name
    reg = obs.get_registry()
    fam = reg.histogram(names.REQUEST_LATENCY_SECONDS,
                        labels=("engine", "kind"))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter(names.REQUEST_LATENCY_SECONDS)
    h = fam.labels(engine="test", kind="e2e")
    h.observe(0.003)
    h.observe(100.0)
    assert h.cumulative()[-1] == (float("inf"), h.count)
    assert h.cumulative()[3] == (0.005, 1)
    assert reqtrace.RequestTraceContext.from_header("abc:7:k").keep
    assert reqtrace.RequestTraceContext.from_header(":x") is None
