"""The phases of the port's training step as named regions, on the CPU.

- Under ``torch.profiler``, each step of a tiny ``LocalOptimizer``
  (Adam, an L2 clip, the non-finite guard on) records ``step.forward``,
  ``step.backward``, ``step.clip``, ``step.update``, ``step.guard`` and
  ``step.write`` once each, in that order, without overlap, inside that
  step's ``step_dispatch``; each loss read back is a ``loss_read``
  outside every ``step_dispatch``.
- With ``BIGDL_TORCH_TRACE_DIR`` set, the obs tracer records the same
  names, each span's parent the step's ``step_dispatch`` span, and
  ``tensors`` the number of parameter tensors.
- No clip set: no ``step.clip``; the guard off: no ``step.guard``;
  neither sink on: no region opens.
- One clock: a region's obs span (``wall_epoch + ts`` of the Chrome
  trace, and the JSONL ``wall_time``) and its profiler event
  (``start_ns``) start within 1 ms of each other on the Unix clock.
- ``DistriOptimizer`` at world 1 (gloo over an in-process store) opens
  the same regions and ``step.exchange`` once a step.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.utils import profiler as P

STEPS = 3
PHASES = ["step.forward", "step.backward", "step.clip", "step.update",
          "step.guard", "step.write"]
COUNTED = {"step.clip", "step.update", "step.guard", "step.write",
           "step.exchange"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("BIGDL_TORCH_PROFILE", "BIGDL_TORCH_TRACE_DIR",
              "BIGDL_TORCH_OBS_PORT", "BIGDL_TORCH_NONFINITE_GUARD"):
        monkeypatch.delenv(k, raising=False)
    Engine.reset()
    tobs.reset()
    yield
    tobs.reset()
    Engine.reset()
    assert not torch.autograd._profiler_enabled()


def _data(n=STEPS * 8):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 6).astype(np.float32),
            (rs.randint(0, 3, n) + 1).astype(np.float32))


def _trainer(clip=True, distri=False):
    import bigdl_tpu_torch.nn as N
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim import (Adam, DistriOptimizer,
                                       LocalOptimizer, Trigger)

    RandomGenerator.RNG.set_seed(3)
    model = (N.Sequential().add(N.Linear(6, 5)).add(N.Tanh())
             .add(N.Linear(5, 3)).add(N.LogSoftMax()))
    x, y = _data()
    cls = DistriOptimizer if distri else LocalOptimizer
    opt = cls(model, ArrayDataSet(x, y, 8, shuffle=False),
              N.ClassNLLCriterion(), batch_size=8, device="cpu")
    opt.set_optim_method(Adam(learningrate=0.01))
    if clip:
        opt.set_gradient_clipping_by_l2_norm(0.5)
    return opt.set_end_when(Trigger.max_iteration(STEPS))


def _kineto(prof) -> list:
    """(name, start_ns, end_ns) of the trace's annotated regions, by
    start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.is_user_annotation()]
    return sorted(out, key=lambda e: e[1])


def _profiled(opt):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt.optimize()
    return _kineto(prof)


def _inside(regions, outer) -> list:
    _, s, e = outer
    return [r for r in regions if r[0] != outer[0] and s <= r[1]
            and r[2] <= e]


def _spans() -> list:
    return [r for r in tobs.get_tracer().recent() if r["kind"] == "span"]


def test_each_step_records_its_phases_in_order_under_the_profiler():
    events = _profiled(_trainer())
    dispatches = [e for e in events if e[0] == "step_dispatch"]
    assert len(dispatches) == STEPS
    for d in dispatches:
        inner = _inside(events, d)
        assert [r[0] for r in inner] == PHASES
        for a, b in zip(inner, inner[1:]):
            assert a[2] <= b[1], (a, b)
    phases = [e for e in events if e[0] in PHASES]
    assert len(phases) == STEPS * len(PHASES)
    reads = [e for e in events if e[0] == "loss_read"]
    assert len(reads) == STEPS
    for r in reads:
        assert not any(d[1] <= r[1] < d[2] for d in dispatches)


def test_the_obs_tracer_records_the_same_names_under_step_dispatch(
        tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    opt = _trainer()
    opt.optimize()
    n_params = len(opt._param_leaves()[1])
    spans = _spans()
    dispatches = [s for s in spans if s["name"] == "step_dispatch"]
    assert sorted(s["attrs"]["step"] for s in dispatches) == [1, 2, 3]
    for d in dispatches:
        kids = sorted((s for s in spans if s["parent"] == d["id"]),
                      key=lambda s: s["wall_time"])
        assert [s["name"] for s in kids] == PHASES
        for a, b in zip(kids, kids[1:]):
            assert a["wall_time"] + a["dur_s"] <= b["wall_time"] + 1e-6
        for s in kids:
            want = {"tensors": n_params} if s["name"] in COUNTED else {}
            assert s["attrs"] == want, s
    reads = [s for s in spans if s["name"] == "loss_read"]
    assert sorted(s["attrs"]["step"] for s in reads) == [1, 2, 3]


@pytest.mark.parametrize("case", ["no_clip", "no_guard"])
def test_an_unset_clip_or_guard_opens_no_region(case, monkeypatch):
    if case == "no_guard":
        monkeypatch.setenv("BIGDL_TORCH_NONFINITE_GUARD", "0")
    events = _profiled(_trainer(clip=case != "no_clip"))
    gone = "step.clip" if case == "no_clip" else "step.guard"
    names = [e[0] for e in events]
    assert gone not in names
    for d in (e for e in events if e[0] == "step_dispatch"):
        assert [r[0] for r in _inside(events, d)] == [
            p for p in PHASES if p != gone]


def test_with_neither_sink_on_no_region_opens(monkeypatch):
    opened = []
    enter = P._AnnotatedRegion.__enter__

    def spy(self):
        out = enter(self)
        opened.append((self.name, self._rf is not None
                       or self._span is not None))
        return out

    monkeypatch.setattr(P._AnnotatedRegion, "__enter__", spy)
    _trainer().optimize()
    names = [n for n, _ in opened]
    for name in PHASES + ["step_dispatch", "loss_read"]:
        assert names.count(name) == STEPS, name
    assert not any(on for _, on in opened)


def test_a_regions_obs_span_and_profiler_event_share_the_clock(
        tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    events = _profiled(_trainer())
    tracer = tobs.get_tracer()
    tracer.flush()
    spans = _spans()
    with open(tracer.trace_path) as f:
        doc = json.load(f)
    epoch = doc["otherData"]["wall_epoch"]
    chrome = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    checked = 0
    for name in PHASES + ["step_dispatch", "loss_read"]:
        prof_starts = [e[1] / 1e9 for e in events if e[0] == name]
        jsonl = sorted(s["wall_time"] for s in spans if s["name"] == name)
        trace = sorted(epoch + e["ts"] / 1e6 for e in chrome
                       if e["name"] == name)
        assert len(prof_starts) == len(jsonl) == len(trace) == STEPS, name
        for p, j, t in zip(prof_starts, jsonl, trace):
            assert abs(p - j) < 1e-3 and abs(p - t) < 1e-3, (name, p, j, t)
            checked += 1
    assert checked == STEPS * (len(PHASES) + 2)


def test_distri_optimizer_at_world_1_opens_the_same_regions_and_exchange(
        tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path))
    opt = _trainer(distri=True)
    opt.optimize()
    assert opt.n_shards == 1 and Engine.node_number() == 1
    n_params = len(opt._param_leaves()[1])
    spans = _spans()
    dispatches = [s for s in spans if s["name"] == "step_dispatch"]
    assert len(dispatches) == STEPS
    want = PHASES[:2] + ["step.exchange"] + PHASES[2:]
    for d in dispatches:
        kids = sorted((s for s in spans if s["parent"] == d["id"]),
                      key=lambda s: s["wall_time"])
        assert [s["name"] for s in kids] == want
        for s in kids:
            assert s["attrs"] == ({"tensors": n_params}
                                  if s["name"] in COUNTED else {}), s


def test_the_trace_files_hold_the_regions(tmp_path, monkeypatch):
    """The profiler's own trace file (``utils.profiler.trace``) and the
    obs JSONL both carry every phase, a step each."""
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "obs"))
    with P.trace(str(tmp_path / "tb")):
        _trainer().optimize()
    tobs.get_tracer().flush()
    files = glob.glob(os.path.join(str(tmp_path / "tb"), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    lines = []
    for path in glob.glob(str(tmp_path / "obs" / "*.jsonl")):
        with open(path) as f:
            lines += [json.loads(line).get("name") for line in f]
    for name in PHASES:
        assert names.count(name) == STEPS and lines.count(name) == STEPS
