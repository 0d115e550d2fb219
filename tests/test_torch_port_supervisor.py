"""The port's restart supervisor and autoscaler
(``bigdl_tpu_torch/resilience/{supervisor,autoscale}.py``) against the
JAX package's, on the CPU, with tiny scripted children (``python -c``)
and the modules' injectable sleeps, clocks and fetches (no wall sleep).

- A child that exits 170, then 1, then 0: the same launches, exported
  attempts and preemptions, exit code, restart counters and backoff
  delays in both packages; the backoff goes through the injected sleep
  and into the goodput ledger as ``supervisor_backoff``.  The port's
  supervisor never initializes CUDA: with ``torch.cuda`` reporting a
  card and every call that would initialize it raising, a supervised
  run and its telemetry flush leave ``torch.cuda.is_initialized()``
  false.
- SIGTERM to the supervisor reaches the child, and the loop stops.
- The hang watchdog: the same verdicts as JAX's on the same
  ``/healthz`` payloads, and a child whose stamp stalls is killed and
  restarted as ``hang`` in both packages.
- The autoscaler: the same ``Decision``s from the same scrape sequences
  through an injected ``fetch``; the port dates a step stamp by
  ``/healthz``'s ``step_age_s`` (JAX by the scrape); and an executed
  resize 1 -> 2: the supervisor stops a world-1 child after its
  checkpoint and relaunches two gloo ranks that resume it, against
  JAX's resume of the same file at world 2 (1e-5, as
  ``tests/test_torch_port_elastic.py`` holds it).
"""

import dataclasses
import json
import os
import signal
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as JN
from bigdl_tpu import obs as jobs
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.config import AutoscaleConfig as JCfg
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.resilience import autoscale as JAs
from bigdl_tpu.resilience import elastic as JE
from bigdl_tpu.resilience import supervisor as JS
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.config import AutoscaleConfig as TCfg
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.resilience import autoscale as TAs
from bigdl_tpu_torch.resilience import supervisor as TS

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_port_distri_worker as W  # noqa: E402

LAUNCHER = os.path.join(HERE, "torch_port_supervised_launcher.py")
_ENV = ("BIGDL_OBS", "BIGDL_TORCH_OBS_PORT",
        "BIGDL_OBS_PORT", "BIGDL_TORCH_METRICS_DIR", "BIGDL_TORCH_TRACE_DIR",
        "BIGDL_TORCH_BUNDLE_DIR", "BIGDL_BUNDLE_DIR",
        "BIGDL_TORCH_OBS_PORT_FILE", "BIGDL_OBS_PORT_FILE")

# attempt 0 preempted, attempt 1 transient, attempt 2 done; each launch
# appends its exported attempt and preemptions to the file
CHILD = r"""
import os, sys
var, log = sys.argv[1], sys.argv[2]
a = int(os.environ[var + "ELASTIC_ATTEMPT"])
p = int(os.environ[var + "ELASTIC_PREEMPTIONS"])
with open(log, "a") as f:
    f.write(f"{a} {p}\n")
sys.exit({0: 170, 1: 1}.get(a, 0))
"""


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


def _restarts(registry):
    for fam in registry.families():
        if fam.name == names.SUPERVISOR_RESTARTS_TOTAL:
            return {dict(zip(fam.labelnames, k))["kind"]: c.value
                    for k, c in fam.child_items()}
    return {}


def _supervise(S, obs, pre, log):
    slept = []
    sup = S.Supervisor([sys.executable, "-c", CHILD, pre, log],
                       sleep=slept.append, hang_timeout=0)
    rc = sup.run()
    with open(log) as f:
        seen = f.read().split("\n")[:-1]
    return (rc, sup.attempt, sup.preemptions, seen, slept,
            _restarts(obs.get_registry()), sup.policy.attempts)


def test_the_launch_sequence_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_METRICS_DIR", str(tmp_path / "m"))
    monkeypatch.setenv("BIGDL_OBS", "1")
    jreload()
    # a card the supervisor must not touch: every call that would
    # initialize CUDA raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def refuse(*a, **k):
        raise AssertionError("the supervisor touched CUDA")
    for fn in ("init", "current_device", "device_count", "memory_stats",
               "set_device", "max_memory_allocated",
               "get_device_properties", "synchronize"):
        monkeypatch.setattr(torch.cuda, fn, refuse)
    t = _supervise(TS, tobs, "BIGDL_TORCH_", str(tmp_path / "t.log"))
    paths = tobs.flush()
    assert not torch.cuda.is_initialized()
    j = _supervise(JS, jobs, "BIGDL_", str(tmp_path / "j.log"))
    assert t == j
    assert t[:4] == (0, 3, 1, ["0 0", "1 1", "2 1"])
    assert t[5] == {"preempted": 1.0, "transient": 1.0}
    assert len(t[4]) == 1 and 0.5 <= t[4][0] <= 0.55
    (rec,) = [r for r in tobs.get_ledger().records()
              if r["kind"] == "supervisor_backoff"]
    assert rec["attrs"] == {"rc": 1, "restart_kind": "transient"}
    assert os.path.exists(paths["goodput"])


def test_sigterm_reaches_the_child_and_stops_the_loop(tmp_path):
    ready, got = str(tmp_path / "ready"), str(tmp_path / "got")
    child = ("import signal, sys, time\n"
             "def h(s, f):\n"
             f"    open({got!r}, 'w').write(str(s)); sys.exit(170)\n"
             "signal.signal(signal.SIGTERM, h)\n"
             f"open({ready!r}, 'w').write('1')\n"
             "time.sleep(60)\n")
    sup = TS.Supervisor([sys.executable, "-c", child], sleep=lambda s: None,
                        hang_timeout=0)

    def signal_when_ready():
        deadline = time.time() + 30
        while not os.path.exists(ready) and time.time() < deadline:
            time.sleep(0.01)
        sup._forward_signal(signal.SIGTERM, None)

    th = threading.Thread(target=signal_when_ready)
    th.start()
    rc = sup.run()
    th.join()
    assert rc == 170 and sup.attempt == 1
    with open(got) as f:
        assert int(f.read()) == signal.SIGTERM


# ---- the hang watchdog ---------------------------------------------------------------
def test_the_watchdog_reads_healthz_as_jax():
    payloads = [None, {"step": None, "step_age_s": None},
                {"step": 3, "step_age_s": 0.1},
                {"step": 3, "step_age_s": 5.0}]
    for p in payloads:
        t = TS.HangWatchdog(1.0, port=1, fetch=lambda url, p=p: p)
        j = JS.HangWatchdog(1.0, port=1, fetch=lambda url, p=p: p)
        assert t.stalled() == j.stalled()
    assert TS.HangWatchdog(1.0, port=1, fetch=lambda url: payloads[3]
                           ).stalled()
    assert not TS.HangWatchdog(1.0, fetch=lambda url: payloads[3]).stalled()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_stalled_child_is_killed_and_restarted(pkg, tmp_path,
                                                 monkeypatch):
    S, pre, obs = (TS, "BIGDL_TORCH_", tobs) if pkg == "torch" else \
        (JS, "BIGDL_", jobs)
    monkeypatch.setenv(pre + "OBS_PORT", "41999")
    sups = []
    # the first launch's stamp stalls; a later one answers fresh (a
    # loaded machine may not have run its child yet at the first poll)
    monkeypatch.setattr(S.HangWatchdog, "_http_fetch", staticmethod(
        lambda url: {"step": 3,
                     "step_age_s": 9.0 if sups[0].attempt == 0 else 0.0}))
    child = ("import os, sys, time\n"
             f"a = int(os.environ['{pre}ELASTIC_ATTEMPT'])\n"
             "time.sleep(60) if a == 0 else sys.exit(0)\n")
    slept = []
    sup = S.Supervisor([sys.executable, "-c", child], sleep=slept.append,
                       hang_timeout=0.2)
    sups.append(sup)
    t0 = time.time()
    assert sup.run() == 0
    assert time.time() - t0 < 30
    assert (sup.attempt, sup.hangs) == (2, 1)
    assert _restarts(obs.get_registry()) == {"hang": 1.0}
    assert len(slept) == 1


# ---- the autoscaler --------------------------------------------------------------
BANDS = dict(enabled=True, min_world=1, max_world=8, factor=2,
             interval_s=1.0, warmup_s=2.0, cooldown_s=5.0, hysteresis=2,
             step_time_high=0.5, queue_high=10.0, goodput_floor=0.3)
# per cycle: (step advance a host, seconds a step, queue depth, goodput)
CYCLES = [(2, 0.2, 0, 0.9), (2, 0.2, 0, 0.9), (1, 0.8, 3, 0.8),
          (1, 0.9, 4, 0.7), (1, 0.9, 20, 0.7), (2, 0.3, 30, 0.6),
          (2, 0.3, 40, 0.2), (3, 0.2, 5, 0.2), (3, 0.2, 5, 0.1),
          (2, 0.2, 0, 0.1), (2, 0.2, 0, 0.9), (1, 1.0, 0, 0.9),
          (1, 1.0, 0, 0.9), (1, 1.0, 50, 0.9), (1, 1.0, 50, 0.9)]


def _decisions(As, Cfg, age):
    state = {"cycle": 0, "t": 100.0, "step": {"h0": 0, "h1": 0}}

    def fetch(url):
        host = url.split("//", 1)[1].split(":", 1)[0]
        adv, per, depth, ratio = CYCLES[state["cycle"]]
        if url.endswith("/healthz"):
            body = {"host": host, "step": state["step"][host],
                    "time": state["t"], "goodput_ratio": ratio,
                    "status": "ok", "alerts": []}
            if age:
                body["step_age_s"] = 0.25 * per
            return json.dumps(body)
        return (f"# TYPE {names.SERVE_QUEUE_DEPTH} gauge\n"
                f"{names.SERVE_QUEUE_DEPTH} {depth}\n")

    scraper = As.EndpointScraper(peers=["h0:1", "h1:1"], fetch=fetch)
    now = [0.0]
    ctrl = As.AutoscaleController(cfg=Cfg(**BANDS), world=2,
                                  scrape=scraper, clock=lambda: now[0])
    out = []
    for k, (adv, per, _d, _r) in enumerate(CYCLES):
        state["cycle"] = k
        for h in state["step"]:
            state["step"][h] += adv
        state["t"] += adv * per
        now[0] = 2.0 + k * 1.0
        d = ctrl.tick()
        if d is not None:
            ctrl.commit(d)
            out.append(dataclasses.asdict(d))
    return out


def test_the_same_decisions_from_the_same_scrapes_as_jax():
    t = _decisions(TAs, TCfg, age=False)
    j = _decisions(JAs, JCfg, age=False)
    assert t == j
    assert [(d["direction"], d["reason"], d["new_world"]) for d in t] == [
        ("up", "step_time_high", 4), ("down", "cost_goodput_floor", 2),
        ("up", "step_time_high", 4)]
    assert TAs.load_rules(None, TCfg(**BANDS)) == \
        JAs.load_rules(None, JCfg(**BANDS))
    with pytest.raises(ValueError):
        TAs.load_rules('[{"name": "x", "signal": "nope", "op": ">", '
                       '"action": "up", "value": 1}]', TCfg())


def test_a_step_stamp_is_dated_by_its_age():
    """Scrapes faster than the steps: JAX reads the scrape interval as
    the step time, the port the stamps' own interval."""
    prev_t, prev_j = {}, {}
    for k, (step, now, age) in enumerate([(1, 10.0, 0.0), (1, 10.2, 0.2),
                                          (2, 10.4, 0.1), (2, 10.6, 0.3),
                                          (3, 10.8, 0.2)]):
        peer = [{"addr": "a", "ok": True, "metrics": {"samples": []},
                 "health": {"step": step, "time": now, "step_age_s": age}}]
        st = TAs.derive_signals(peer, prev_t, 1).get("step_time_s")
        sj = JAs.derive_signals(peer, prev_j, 1).get("step_time_s")
        if k == 2:
            assert st == pytest.approx(0.3) and sj == pytest.approx(0.2)
        if k == 4:
            assert st == pytest.approx(0.3) and sj == pytest.approx(0.2)


def test_a_restamped_step_is_dated_by_its_newest_stamp():
    """A resumed child stamps its restored step 6 at the restore (t=100)
    and again when step 6 trains (t=102.5): the next step's sample is
    the trained interval, not the restore's seconds with it."""
    prev = {}
    got = []
    for step, now, age in [(6, 100.0, 0.0), (6, 101.0, 1.0),
                           (6, 102.6, 0.1), (7, 103.4, 0.0),
                           (7, 103.6, 0.2), (8, 104.5, 0.1)]:
        peer = [{"addr": "a", "ok": True, "metrics": {"samples": []},
                 "health": {"step": step, "time": now, "step_age_s": age}}]
        st = TAs.derive_signals(peer, prev, 1).get("step_time_s")
        if st is not None:
            got.append(st)
    assert got == [pytest.approx(0.9), pytest.approx(1.0)]


def _jax_resume_at_2(ck):
    x, y = W.data(W.CKPT_N)
    JRandom.RNG.set_seed(4)
    mesh = JEngine.build_mesh({"data": 2}, devices=jax.devices()[:2])
    make = lambda m, d: JDistri(  # noqa: E731
        m, d, JN.ClassNLLCriterion(), 8, mesh=mesh, **W.CKPT_KW)
    model, opt, losses = W.ckpt_run(JN, JO, make,
                                    JArray(x, y, 8, shuffle=False),
                                    resume=ck,
                                    restore_latest=JE.restore_latest)
    out = {f"p{i}": np.asarray(v)
           for i, v in enumerate(jax.tree.leaves(model.params()))}
    out["losses"] = np.asarray([losses.loss[n] for n in sorted(losses.loss)])
    return out


def test_an_executed_resize_1_to_2_resumes_as_jax(tmp_path):
    tmp, ck, out = str(tmp_path), str(tmp_path / "ck"), str(
        tmp_path / "resumed.npz")
    os.makedirs(ck)
    ready = os.path.join(tmp, "ready")
    cfg = TCfg(enabled=True, min_world=1, max_world=2, factor=2,
               interval_s=0.1, warmup_s=0.0, cooldown_s=1e3, hysteresis=1)
    rules = [{"name": "grow", "signal": "goodput_ratio", "op": "<",
              "value": 0.9, "action": "up", "for": 1}]
    ctrl = TAs.AutoscaleController(cfg=cfg, world=1, rules=rules,
                                   scrape=lambda: [])

    def scrape():
        if ctrl.world != 1 or not os.path.exists(ready):
            return []
        return [{"addr": "a", "ok": True, "metrics": {"samples": []},
                 "health": {"goodput_ratio": 0.5, "time": time.time()}}]

    ctrl._scrape = scrape
    slept = []
    sup = TS.Supervisor([sys.executable, LAUNCHER, tmp, ck, out],
                        sleep=slept.append, hang_timeout=0,
                        autoscaler=ctrl, stop_grace_s=60)
    assert sup.run() == 0
    assert (sup.resizes, ctrl.world, sup.attempt) == (1, 2, 2)
    assert [(d.direction, d.resize, d.dry_run) for d in ctrl.decisions] \
        == [("up", "1to2", False)]
    assert _restarts(tobs.get_registry()) == {"resize": 1.0}
    t = dict(np.load(out))
    j = _jax_resume_at_2(ck)
    assert len(t["losses"]) == len(j["losses"]) == 4
    for k in j:
        scale = max(1.0, float(np.abs(j[k]).max()))
        assert float(np.abs(t[k] - j[k]).max()) <= 1e-5 * scale, k
    # the new world's error-feedback residual holds its own errors
    assert t["opt_wire_ef"].shape[0] == 2
