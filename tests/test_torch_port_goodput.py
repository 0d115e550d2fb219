"""The port's goodput ledger (``bigdl_tpu_torch/obs/goodput.py``), the
``/healthz`` attempt and the ``engine.init_barrier`` event against the
JAX package's, on the CPU.

- One scripted interval sequence through both ledgers (the same wall
  anchor): equal records, equal ``classify_records`` (1e-9), and over
  three attempts' shards equal ``aggregate_goodput`` (1e-9), each
  package reading the other's shards.
- A LeNet-5 ``DistriOptimizer`` run in each package, checkpointed every
  4 steps and killed after step 6 by a train summary that raises
  ``SystemExit`` (the pattern of ``chip_smoke.py``'s children), then
  resumed in a second attempt through ``restore_latest``: the same
  steps re-tagged ``rework`` (5 and 6) and the same set of causes (the
  JAX package's ``compile`` aside: the port has no jit).
- ``health_payload()["attempt"]`` reads the attempt each package's own
  variable exports (the port read 0 whatever the launch).
- ``Engine.init`` emits ``engine.init_barrier`` with JAX's attributes.
"""

import json
import os

import jax
import numpy as np
import pytest

from bigdl_tpu import nn as JN
from bigdl_tpu import obs as jobs
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.config import reload_from_env as jreload
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.dataset.mnist import load_mnist as jload, normalize as jnorm
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.models.lenet import build_lenet5 as jlenet
from bigdl_tpu.obs import goodput as JG
from bigdl_tpu.obs import server as jserver
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.resilience import elastic as JE
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.config import reload_from_env as treload
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.dataset.mnist import load_mnist as tload, normalize as tnorm
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models.lenet import build_lenet5 as tlenet
from bigdl_tpu_torch.obs import goodput as TG
from bigdl_tpu_torch.obs import server as tserver
from bigdl_tpu_torch.resilience import elastic as TE

TOL = 1e-9
_ENV = ("BIGDL_METRICS_DIR", "BIGDL_TORCH_METRICS_DIR", "BIGDL_TRACE_DIR",
        "BIGDL_TORCH_TRACE_DIR", "BIGDL_ELASTIC_ATTEMPT",
        "BIGDL_TORCH_ELASTIC_ATTEMPT", "BIGDL_GOODPUT_WINDOW",
        "BIGDL_TORCH_GOODPUT_WINDOW", "BIGDL_OBS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    Engine.reset()
    JEngine.reset()
    tobs.reset()
    jobs.reset()
    yield
    Engine.reset()
    JEngine.reset()
    tobs.reset()
    jobs.reset()
    TE.clear_preemption()
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jreload()
    treload()


# ---- one scripted interval sequence -------------------------------------------
# (kind, start offset s, duration s, step): a first attempt with a
# compile inside its first step, a data wait, an eval and a checkpoint
SCRIPT = [("compile", 0.30, 0.20, None), ("step", 0.25, 0.40, 1),
          ("data_wait", 0.70, 0.05, 2), ("step", 0.75, 0.10, 2),
          ("step", 0.85, 0.10, 3), ("checkpoint_save", 0.95, 0.08, 3),
          ("eval", 1.05, 0.03, 3), ("step", 1.10, 0.10, 4),
          ("step", 1.20, 0.10, 5)]


def _scripted(G, directory, attempt, host=0, resume_at=None):
    """Record SCRIPT (shifted by the attempt) through package ``G``'s
    ledger with a fixed wall anchor; returns the ledger."""
    led = G.GoodputLedger(directory, host_id=host, attempt=attempt)
    wall0, perf0 = 1.0e9 + 100.0 * attempt, 50.0
    led._epoch_wall, led._epoch_perf = wall0, perf0
    led._records[0]["wall"] = wall0
    led._records[0]["start_perf"] = perf0
    led._unflushed[0] = led._records[0]
    if resume_at is not None:
        led.stamp_resume(resume_at)
        led._records[-1]["wall"] = wall0
    for kind, start, dur, step in SCRIPT:
        led.record(kind, perf0 + start, dur, step=step)
    led.note_host_seconds(0.01)
    led.set_comm_bytes_per_step(1e6)
    return led


def _norm(recs):
    out = []
    for r in recs:
        r = dict(r)
        r.pop("pid", None)
        out.append(r)
    return out


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_scripted_sequence_classifies_as_jax(monkeypatch):
    monkeypatch.setenv("BIGDL_GOODPUT_WINDOW", "2")
    monkeypatch.setenv("BIGDL_TORCH_GOODPUT_WINDOW", "2")
    jreload()
    t = _scripted(TG, None, 0)
    j = _scripted(JG, None, 0)
    assert _norm(t.records()) == _norm(j.records())
    ct, cj = TG.classify_records(t.records()), JG.classify_records(
        j.records())
    _close(ct, cj)
    assert ct["rework_steps"] == 0 and ct["steps"] == 5
    assert set(ct["badput_s"]) == {"compile", "data_wait",
                                   "checkpoint_save", "eval", "startup"}
    # the first step's compile is charged to `compile`, not to `step`
    assert ct["seconds"]["compile"] == pytest.approx(0.2)
    assert TG.classify_bottleneck(1.0, 0.5, 0.1, 0.2) == \
        JG.classify_bottleneck(1.0, 0.5, 0.1, 0.2)
    assert t.live_ratio() is not None


def test_three_attempts_aggregate_as_jax(tmp_path):
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    for attempt in range(3):
        resume = None if attempt == 0 else 3
        for G, d in ((TG, td), (JG, jd)):
            led = _scripted(G, d, attempt, resume_at=resume)
            led.flush()
    at, aj = TG.aggregate_goodput(td), JG.aggregate_goodput(jd)
    for a in (at, aj):
        for p in a["per_attempt"]:
            p.pop("pid")
    _close(at, aj)
    # attempts 1 and 2 replay steps 1-5 under attempt 0's mark of 5
    assert at["attempts"] == 3 and at["rework_steps"] == 10
    # each package reads the other's shards to the same numbers
    _close(JG.aggregate_goodput(td), TG.aggregate_goodput(jd), "cross")
    assert TG.prior_high_water(td) == JG.prior_high_water(jd) == 5
    names = sorted(os.listdir(td))
    assert all(n.startswith("goodput.h0.") and n.endswith(".jsonl")
               for n in names) and len(names) == 3


# ---- a killed LeNet-5 run, resumed ----------------------------------------------
class _Kill:
    """A train summary that raises SystemExit(1) once step ``at``'s
    loss is read (``at`` None: never)."""

    def __init__(self, at):
        self.at = at

    def add_scalar(self, tag, value, step):
        if tag == "Loss" and step == self.at:
            raise SystemExit(1)

    def get_summary_trigger(self, name):
        return None


def _lenet_attempt(pkg, ck, attempt, kill_at):
    if pkg == "torch":
        TRandom.RNG.set_seed(0)
        model = tlenet(device="cpu")
        x, y = tload(None, "train", synthetic_n=256)
        opt = TO.DistriOptimizer(model, TArray(tnorm(x), y, 32,
                                               shuffle=False),
                                 TN.ClassNLLCriterion(), 32, device="cpu",
                                 wire_dtype="float32")
        sgd, trig, restore = TO.SGD, TO.Trigger, TE.restore_latest
    else:
        JRandom.RNG.set_seed(0)
        model = jlenet()
        x, y = jload(None, "train", synthetic_n=256)
        opt = JDistri(model, JArray(jnorm(x), y, 32, shuffle=False),
                      JN.ClassNLLCriterion(), 32,
                      mesh=JEngine.build_mesh({"data": 1},
                                              devices=jax.devices()[:1]),
                      wire_dtype="float32")
        sgd, trig, restore = JO.SGD, JO.Trigger, JE.restore_latest
    opt.set_optim_method(sgd(learningrate=0.1, momentum=0.9))
    opt.set_end_when(trig.max_iteration(8))
    opt.set_checkpoint(ck, trig.several_iteration(4))
    opt.set_train_summary(_Kill(kill_at))
    if attempt > 0:
        restore(opt)
    try:
        opt.optimize()
    except SystemExit as e:
        assert e.code == 1 and kill_at is not None


def _killed_and_resumed(pkg, tmp, monkeypatch):
    pre = "BIGDL_TORCH_" if pkg == "torch" else "BIGDL_"
    mdir, ck = os.path.join(tmp, pkg + "_m"), os.path.join(tmp, pkg + "_ck")
    O = tobs if pkg == "torch" else jobs
    monkeypatch.setenv(pre + "METRICS_DIR", mdir)
    for attempt, kill_at in ((0, 6), (1, None)):
        monkeypatch.setenv(pre + "ELASTIC_ATTEMPT", str(attempt))
        (treload if pkg == "torch" else jreload)()
        _lenet_attempt(pkg, ck, attempt, kill_at)
        O.flush()              # the exit's flush: the attempt's shard lands
        O.reset()
        (Engine if pkg == "torch" else JEngine).reset()
    G = TG if pkg == "torch" else JG
    shards = G.read_ledger_shards(mdir)
    kinds = {(r["kind"], r.get("step")) for s in shards
             for r in s["records"] if r["kind"] in ("step", "rework")}
    causes = {r["kind"] for s in shards for r in s["records"]
              if r["kind"] in G.PRIORITY}
    return kinds, causes, G.aggregate_goodput(mdir)


def test_killed_lenet_resume_retags_the_same_steps_as_jax(tmp_path,
                                                          monkeypatch):
    tk, tc, ta = _killed_and_resumed("torch", str(tmp_path), monkeypatch)
    jk, jc, ja = _killed_and_resumed("jax", str(tmp_path), monkeypatch)
    assert tk == jk
    assert sorted(s for k, s in tk if k == "rework") == [5, 6]
    assert sorted(s for k, s in tk if k == "step") == list(range(1, 9))
    assert tc == jc - {"compile"}
    assert {"startup", "step", "rework", "checkpoint_save",
            "checkpoint_restore", "data_wait"} <= tc
    assert ta["rework_steps"] == ja["rework_steps"] == 2
    assert ta["attempts"] == ja["attempts"] == 2
    assert 0 < ta["goodput_ratio"] <= 1


# ---- /healthz's attempt, the barrier event -----------------------------------------
def test_healthz_attempt_reads_each_packages_variable(monkeypatch):
    """On the parent commit the port read 0 whatever the launch."""
    monkeypatch.setenv("BIGDL_ELASTIC_ATTEMPT", "2")
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_ATTEMPT", "2")
    jreload()
    assert jserver.health_payload()["attempt"] == 2
    assert tserver.health_payload()["attempt"] == 2
    assert set(tserver.health_payload()) == set(jserver.health_payload())
    monkeypatch.setenv("BIGDL_TORCH_ELASTIC_ATTEMPT", "0")
    assert tserver.health_payload()["attempt"] == 0


def _events(d):
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".events.jsonl"):
            with open(os.path.join(d, fn)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def test_engine_init_emits_the_barrier_event_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TRACE_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "t"))
    jreload()
    JEngine.init()
    Engine.init("cpu")
    jobs.get_tracer().flush()
    tobs.get_tracer().flush()
    (jb,) = [e for e in _events(str(tmp_path / "j"))
             if e["name"] == "engine.init_barrier"]
    (tb,) = [e for e in _events(str(tmp_path / "t"))
             if e["name"] == "engine.init_barrier"]
    assert set(tb["attrs"]) == set(jb["attrs"]) == {"host", "processes",
                                                    "devices"}
    assert (tb["attrs"]["host"], tb["attrs"]["processes"],
            tb["attrs"]["devices"]) == (0, 1, 1)
    assert tb["kind"] == jb["kind"] == "event"


def test_a_restore_before_the_first_step_is_counted_once_live():
    """A resume restores inside the startup window: JAX's live ratio
    adds both and reads 0 until the productive seconds outgrow the
    restore; the port counts each second once."""
    ratios = {}
    for name, G in (("t", TG), ("j", JG)):
        led = G.GoodputLedger(None, host_id=0, attempt=1)
        p0 = led._epoch_perf
        led.record("checkpoint_restore", p0, 2.0)
        led.record("step", p0 + 2.5, 0.5, step=9)
        led.record("step", p0 + 3.0, 0.5, step=10)
        # 4 s after birth: 2 s restored, 0.5 s more of startup, 1 s of
        # steps, 0.5 s not yet accounted
        led._epoch_wall -= 4.0 - (led._wall(p0) - led._epoch_wall)
        ratios[name] = led.live_ratio()
        assert G.classify_records(led.records())["badput_s"][
            "checkpoint_restore"] == pytest.approx(2.0)
    assert ratios["j"] == 0.0
    assert ratios["t"] == pytest.approx(0.25, abs=0.01)
