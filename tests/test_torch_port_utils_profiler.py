"""``utils/profiler`` (on ``torch.profiler``) and ``utils/logger_filter``
of the port, on the CPU.

- ``StepProfiler`` traces exactly iterations ``[skip, skip + steps)``:
  driven by hand, and hooked into a tiny ``LocalOptimizer`` through
  ``BIGDL_TORCH_PROFILE``, where the trace file holds one
  ``step_dispatch`` region for each traced step (and ``iteration`` and
  ``device_put`` for each but the first, which began before the trace)
  and the profiler was on for exactly those steps' dispatches.
- ``stop()`` runs when ``optimize`` raises: no trace is left recording
  and the file is written.
- An ``annotate`` region, as a context manager and as a decorator, is
  in both the trace file and the obs tracer's JSONL under one name; with
  neither on it opens nothing.
- The logger filter: both packages, given the same ``chatty`` and
  ``keep`` lists and a temporary ``log_path``, leave the same handler
  types and levels and the same propagation; a second call replaces the
  handlers instead of adding to them; the disable knob skips all; the
  default file is per-user in the temp directory.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.utils import profiler as P


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("BIGDL_TORCH_PROFILE", "BIGDL_TORCH_TRACE_DIR",
              "BIGDL_TORCH_DISABLE_LOGGER", "BIGDL_TORCH_LOG_PATH",
              "BIGDL_DISABLE_LOGGER", "BIGDL_LOG_PATH"):
        monkeypatch.delenv(k, raising=False)
    tobs.reset()
    yield
    tobs.reset()
    assert not torch.autograd._profiler_enabled()


def _trace_events(d) -> list:
    files = glob.glob(os.path.join(str(d), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _names(events, name) -> list:
    return [e for e in events if e.get("name") == name]


def test_step_profiler_window_by_hand(tmp_path):
    sp = P.StepProfiler(str(tmp_path), skip=2, steps=3)
    on = []
    for n in range(8):
        sp.step()
        with P.annotate("work"):
            torch.ones(4).add_(1)
        on.append(torch.autograd._profiler_enabled())
    sp.stop()
    assert on == [False, False, True, True, True, False, False, False]
    assert len(_names(_trace_events(tmp_path), "work")) == 3
    off = P.StepProfiler()
    assert not off.enabled
    off.step()
    assert not off.active


def _tiny_trainer(n=64, batch=8):
    import bigdl_tpu_torch.nn as N
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    RandomGenerator.RNG.set_seed(3)
    model = (N.Sequential().add(N.Linear(6, 5)).add(N.Tanh())
             .add(N.Linear(5, 3)).add(N.LogSoftMax()))
    rs = np.random.RandomState(0)
    x = rs.randn(n, 6).astype(np.float32)
    y = (rs.randint(0, 3, n) + 1).astype(np.float32)
    opt = LocalOptimizer(model, (x, y), N.ClassNLLCriterion(),
                         batch_size=batch, device="cpu")
    opt.set_optim_method(SGD(learningrate=0.1))
    return opt


def test_profile_knob_traces_steps_one_on(tmp_path, monkeypatch):
    from bigdl_tpu_torch.optim import Trigger

    monkeypatch.setenv("BIGDL_TORCH_PROFILE", str(tmp_path))
    opt = _tiny_trainer()
    on = {}
    real = opt._train_step

    def watched(*a, **k):
        on[opt.state["neval"]] = torch.autograd._profiler_enabled()
        return real(*a, **k)

    opt._train_step = watched
    opt.set_end_when(Trigger.max_iteration(5)).optimize()
    assert on == {1: False, 2: True, 3: True, 4: True, 5: True}
    events = _trace_events(tmp_path)
    # the trace starts once the first traced step's batch is on the
    # device: that step's iteration and device_put regions began before
    assert len(_names(events, "step_dispatch")) == 4
    assert len(_names(events, "iteration")) == 3
    assert len(_names(events, "device_put")) == 3
    assert not opt._step_profiler.active


class _Boom:
    def add_scalar(self, tag, value, step):
        if tag == "Loss" and step == 3:
            raise RuntimeError("boom at 3")


def test_stop_runs_when_optimize_raises(tmp_path, monkeypatch):
    from bigdl_tpu_torch.optim import Trigger

    monkeypatch.setenv("BIGDL_TORCH_PROFILE", str(tmp_path))
    opt = _tiny_trainer()
    opt.set_train_summary(_Boom())
    opt.set_end_when(Trigger.max_iteration(6))
    with pytest.raises(RuntimeError, match="boom at 3"):
        opt.optimize()
    assert not torch.autograd._profiler_enabled()
    assert _names(_trace_events(tmp_path), "step_dispatch")
    # a second optimize starts a new trace: none was left recording
    opt.set_train_summary(None)
    opt.optimize()


@P.annotate("decorated", kind="fn")
def _decorated(x):
    return x * 2


def test_annotate_reaches_both_sinks_under_one_name(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "obs"))
    with P.trace(str(tmp_path / "tb")):
        with P.annotate("my_region", k=1):
            torch.ones(8).mul_(3)
        _decorated(torch.ones(2))
    events = _trace_events(tmp_path / "tb")
    tracer = tobs.get_tracer()
    tracer.flush()
    spans = [r for r in tracer.recent() if r.get("kind") == "span"]
    for name, attrs in (("my_region", {"k": 1}), ("decorated",
                                                  {"kind": "fn"})):
        assert len(_names(events, name)) == 1, name
        got = [s for s in spans if s["name"] == name]
        assert len(got) == 1 and got[0]["attrs"] == attrs
    lines = []
    for path in glob.glob(str(tmp_path / "obs" / "*.jsonl")):
        with open(path) as f:
            lines += [json.loads(line) for line in f]
    assert {"my_region", "decorated"} <= {r.get("name") for r in lines}


def test_annotate_opens_nothing_when_off():
    region = P.annotate("idle")
    with region:
        assert region._rf is None and region._span is None


# ---- the logger filter ------------------------------------------------------------
def _state(names) -> list:
    out = []
    for name in names:
        lg = logging.getLogger(name)
        out.append((lg.level, lg.propagate, sorted(
            (type(h).__name__, h.level) for h in lg.handlers)))
    return out


def _drop(names):
    for name in names:
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()
        lg.setLevel(logging.NOTSET)
        lg.propagate = True


def test_logger_filter_matches_jax(tmp_path):
    from bigdl_tpu.utils.logger_filter import LoggerFilter as JLF
    from bigdl_tpu_torch.utils.logger_filter import LoggerFilter as TLF

    sides = {"j": (JLF, ("lfj.a", "lfj.a.b", "lfj.c"), ("lfj.keep",)),
             "t": (TLF, ("lft.a", "lft.a.b", "lft.c"), ("lft.keep",))}
    try:
        states = {}
        for key, (lf, chatty, keep) in sides.items():
            path = str(tmp_path / f"{key}.log")
            lf.redirectSparkInfoLogs(path, chatty=chatty, keep=keep)
            first = _state(chatty + keep)
            lf.redirect_spark_info_logs(path, chatty=chatty, keep=keep)
            assert _state(chatty + keep) == first       # idempotent
            states[key] = first
            logging.getLogger(chatty[0]).info("to the file %s", key)
            for h in logging.getLogger(chatty[0]).handlers:
                h.flush()
            with open(path) as f:
                assert f"to the file {key}" in f.read()
        assert states["t"] == states["j"]
        level, propagate, handlers = states["t"][0]
        assert (level, propagate) == (logging.INFO, False)
        assert handlers == [("FileHandler", logging.INFO),
                            ("StreamHandler", logging.WARNING)]
    finally:
        for _, chatty, keep in sides.values():
            _drop(chatty + keep)


def test_logger_filter_knobs(tmp_path, monkeypatch):
    import tempfile

    from bigdl_tpu_torch.utils import logger_filter as LF

    names = ("lfk.a",)
    try:
        monkeypatch.setenv("BIGDL_TORCH_DISABLE_LOGGER", "1")
        LF.redirect_spark_info_logs(chatty=names, keep=())
        assert logging.getLogger("lfk.a").handlers == []
        monkeypatch.delenv("BIGDL_TORCH_DISABLE_LOGGER")
        monkeypatch.setenv("BIGDL_TORCH_LOG_PATH", str(tmp_path / "env.log"))
        LF.redirect_spark_info_logs(chatty=names, keep=())
        files = [h.baseFilename for h in logging.getLogger("lfk.a").handlers
                 if isinstance(h, logging.FileHandler)]
        assert files == [str(tmp_path / "env.log")]
        monkeypatch.delenv("BIGDL_TORCH_LOG_PATH")
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
        os.makedirs(tempfile.tempdir)
        LF.redirect_spark_info_logs(chatty=names, keep=())
        files = [h.baseFilename for h in logging.getLogger("lfk.a").handlers
                 if isinstance(h, logging.FileHandler)]
        assert len(files) == 1
        assert os.path.dirname(files[0]) == tempfile.tempdir
        assert os.path.basename(files[0]).startswith("bigdl-torch-")
        assert "torch" in LF._DEFAULT_CHATTY and "jax" not in \
            LF._DEFAULT_CHATTY
    finally:
        _drop(names)
