"""The port's background checkpoint writes (``set_checkpoint(
background=True)``) against its synchronous ones and the JAX package's,
on the CPU.

- A ``LocalOptimizer`` and a ``DistriOptimizer`` run with background
  writes leave the same checkpoints, array for array (exactly), as the
  same run with synchronous writes, and the same final weights; the
  JAX package loads the newest of them (exactly).
- A failed background write surfaces as ``CheckpointWriteError`` at the
  next trigger, and is counted once (``checkpoint_write_failures``,
  ``bigdl_checkpoint_write_failures_total``, the summary's
  "CheckpointWriteFailures"); one that fails during a failed run
  surfaces at the next ``optimize``.
- At most one write is in flight: the writer is held until the next
  trigger has waited for it (checked on state, not on time).
- ``keep_last`` holds; the ``checkpoint.*`` spans are recorded; no
  writer thread outlives a run.
"""

import os
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.resilience.retry import CheckpointWriteError
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("BIGDL_TORCH_FAULT_PLAN", raising=False)
    monkeypatch.delenv("BIGDL_TORCH_CHECKPOINT_ASYNC", raising=False)
    Engine.reset()
    obs.reset()
    yield
    Engine.reset()
    obs.reset()


def _model():
    return TN.Sequential() \
        .add(TN.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(TN.SpatialBatchNormalization(4)).add(TN.ReLU()) \
        .add(TN.Reshape([4 * 6 * 6])).add(TN.Linear(144, 3)) \
        .add(TN.LogSoftMax())


def _run(ck, background, cls=TO.LocalOptimizer, iters=9, keep_last=0,
         summary=None):
    rs = np.random.RandomState(0)
    x = rs.randn(48, 3, 6, 6).astype(np.float32)
    y = (rs.randint(0, 3, 48) + 1).astype(np.float32)
    TRandom.RNG.set_seed(4)
    model = _model()
    kw = {"wire_dtype": "float32"} if cls is TO.DistriOptimizer else {}
    opt = cls(model, TArray(x, y, 8), TN.ClassNLLCriterion(), 8,
              device="cpu", **kw)
    opt.set_optim_method(TO.SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(TO.Trigger.max_iteration(iters))
    opt.set_checkpoint(str(ck), TO.Trigger.several_iteration(2),
                       background=background, keep_last=keep_last)
    if summary is not None:
        opt.set_train_summary(summary)
    TRandom.RNG.set_seed(9)
    opt.optimize()
    return model, opt


def _arrays(prefix):
    out = {}
    for suffix in (".model.npz", ".optim.npz"):
        with np.load(prefix + suffix) as d:
            out.update({suffix + k: np.array(d[k]) for k in d.files})
    return out


@pytest.mark.parametrize("cls", ["LocalOptimizer", "DistriOptimizer"])
def test_background_writes_equal_synchronous_ones(tmp_path, cls):
    cls = getattr(TO, cls)
    sm, so = _run(tmp_path / "sync", False, cls)
    bm, bo = _run(tmp_path / "bg", True, cls)
    assert bo.checkpoint_background and not so.checkpoint_background
    assert bo._ckpt_executor is None and bo._ckpt_future is None
    # after iterations 2, 4 and 6, at epoch 1's end and after 8
    names = sorted(TS.checkpoint_prefixes(str(tmp_path / "sync")))
    assert names == ["checkpoint_1_3", "checkpoint_1_5", "checkpoint_1_7",
                     "checkpoint_2_7", "checkpoint_2_9"]
    assert sorted(TS.checkpoint_prefixes(str(tmp_path / "bg"))) == names
    for name in names:
        a = _arrays(os.path.join(str(tmp_path / "sync"), name))
        b = _arrays(os.path.join(str(tmp_path / "bg"), name))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert TS.verify_checkpoint(
            os.path.join(str(tmp_path / "bg"), name))[0]
    for p, q in zip(T.leaves(sm.params()), T.leaves(bm.params())):
        assert torch.equal(p, q)
    if cls is TO.LocalOptimizer:
        # the JAX package reads the newest background checkpoint
        from bigdl_tpu import nn as JN
        import jax

        jm = JN.Sequential() \
            .add(JN.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
            .add(JN.SpatialBatchNormalization(4)).add(JN.ReLU()) \
            .add(JN.Reshape([4 * 6 * 6])).add(JN.Linear(144, 3)) \
            .add(JN.LogSoftMax())
        extra = JS.load_latest_checkpoint(str(tmp_path / "bg"), jm, JSGD())
        assert extra["neval"] == 9
        saved = _arrays(os.path.join(str(tmp_path / "bg"), names[-1]))
        for i, q in enumerate(jax.tree.leaves(jm.params())):
            np.testing.assert_array_equal(saved[f".model.npzp{i}"],
                                          np.asarray(q))


class _Resilience:
    def __init__(self):
        self.counters = {}

    def add_scalar(self, *a):
        pass

    def add_resilience(self, step, **counters):
        self.counters.update({k: v for k, v in counters.items()
                              if v is not None})


def _failures_total():
    for fam in obs.get_registry().families():
        if fam.name == "bigdl_checkpoint_write_failures_total":
            return fam.child_items()[0][1].value
    return 0


def test_a_failed_write_surfaces_at_the_next_trigger(tmp_path, monkeypatch):
    real = TS.write_manifest
    calls = []

    def failing(prefix, *a, **k):
        calls.append(prefix)
        if len(calls) == 2:
            raise OSError("disk gone")
        return real(prefix, *a, **k)

    monkeypatch.setattr(TS, "write_manifest", failing)
    summary = _Resilience()
    with pytest.raises(CheckpointWriteError, match="disk gone") as info:
        _run(tmp_path / "ck", True, summary=summary)
    assert isinstance(info.value.__cause__, OSError)
    assert len(calls) == 2              # the third trigger did not write
    assert summary.counters == {"checkpoint_write_failures": 1}
    assert _failures_total() == 1


def test_a_failure_recorded_by_a_failed_run_surfaces_next(tmp_path,
                                                          monkeypatch):
    gate = threading.Event()
    real = TS.write_checkpoint

    def held_then_failing(snap, prefix, keep, background):
        gate.wait(30)
        raise OSError("late failure")

    def failing_put(*a):
        raise RuntimeError("step")

    model, opt = _run(tmp_path / "warm", True, iters=1)
    monkeypatch.setattr(TS, "write_checkpoint", held_then_failing)
    # the loop fails while the write is held; the finally flush records
    # the write's failure without hiding the loop's own error
    opt._put_batch = failing_put
    opt._checkpoint()
    gate.set()
    with pytest.raises(RuntimeError, match="step"):
        opt.set_end_when(TO.Trigger.max_iteration(3)).optimize()
    assert opt.checkpoint_write_failures == 1
    monkeypatch.setattr(TS, "write_checkpoint", real)
    with pytest.raises(CheckpointWriteError, match="late failure"):
        opt.optimize()
    assert _failures_total() == 1


def test_at_most_one_write_in_flight(tmp_path, monkeypatch):
    real = TS.write_checkpoint
    state = {"active": 0, "max": 0, "writes": 0}
    lock = threading.Lock()
    release = threading.Event()
    waiting = threading.Event()

    def tracked(snap, prefix, keep, background):
        with lock:
            state["active"] += 1
            state["max"] = max(state["max"], state["active"])
        if state["writes"] == 0:
            waiting.set()
            release.wait(30)              # held until the next trigger
        try:
            return real(snap, prefix, keep, background)
        finally:
            with lock:
                state["active"] -= 1
                state["writes"] += 1

    monkeypatch.setattr(TS, "write_checkpoint", tracked)
    real_flush = TO.LocalOptimizer._flush_checkpoints

    def flush(self, raise_errors=True):
        if self._ckpt_future is not None and not release.is_set():
            assert waiting.wait(30)      # the first write is held now
            assert not self._ckpt_future.done()
            release.set()
        return real_flush(self, raise_errors)

    monkeypatch.setattr(TO.LocalOptimizer, "_flush_checkpoints", flush)
    _run(tmp_path / "ck", True, iters=6)
    assert state["max"] == 1 and state["writes"] == 3


def test_keep_last_and_the_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    obs.reset()
    before = {t.ident for t in threading.enumerate()}
    _run(tmp_path / "ck", True, keep_last=2)
    assert len(TS.checkpoint_prefixes(str(tmp_path / "ck"))) == 2
    _run(tmp_path / "sync", False, iters=2)
    model = _model()
    TS.load_latest_checkpoint(str(tmp_path / "ck"), model)
    assert {t.ident for t in threading.enumerate()} <= before
    names = [r["name"] for r in obs.get_tracer().recent()]
    for span in ("checkpoint.snapshot", "checkpoint.write_async",
                 "checkpoint.write", "checkpoint.verify", "checkpoint.load",
                 "checkpoint"):
        assert span in names, span
    fams = {f.name: f for f in obs.get_registry().families()}
    assert fams["bigdl_checkpoint_writes_total"].child_items()[0][1].value \
        == 6
    for gauge in ("bigdl_checkpoint_snapshot_seconds",
                  "bigdl_checkpoint_write_seconds"):
        assert fams[gauge].child_items()[0][1].value >= 0
