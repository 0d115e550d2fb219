"""The port's streaming dataset (``dataset/stream.py``) against the JAX
package's, on the CPU.

- ``SyntheticStream``'s records are bit-equal to JAX's (features,
  labels, event times) from any offset, and a replay is bit-identical.
- ``BoundedBuffer`` under backpressure drops nothing: its producer
  waits at capacity (counted), the consumer reads every offset in
  order, and the thread is gone after ``stop``.
- ``StreamDataSet``'s batches equal JAX's; the trained offset rides the
  checkpoint's ``extra`` and manifest, as in JAX.
- A ``DistriOptimizer`` (world 1) on a stream with background
  checkpoints and ``step:N:raise`` resumes from the checkpoint's offset:
  the surviving trajectory trains every record exactly once, the final
  weights are bit-equal to the uninterrupted run, and within 1e-5 of
  JAX's ``LocalOptimizer`` on the same stream (the JAX stream tests'
  MLP).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import stream as JSt
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import obs
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import stream as TSt
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("BIGDL_TORCH_FAULT_PLAN", raising=False)
    monkeypatch.setenv("BIGDL_TORCH_RETRY_BACKOFF_BASE", "0")
    Engine.reset()
    obs.reset()
    yield
    Engine.reset()
    obs.reset()


def _value(name):
    """The value of an unlabelled family, ``None`` before its first
    sample."""
    for fam in obs.get_registry().families():
        if fam.name == name:
            items = fam.child_items()
            return items[0][1].value if items else None
    return None


@pytest.mark.parametrize("seed,offset", [(0, 0), (3, 17), (11, 1000)])
def test_records_equal_jax(seed, offset):
    t = TSt.SyntheticStream(feature_dim=16, n_classes=4, seed=seed,
                            limit=offset + 40)
    j = JSt.SyntheticStream(feature_dim=16, n_classes=4, seed=seed,
                            limit=offset + 40)
    got, want = list(t.read(offset)), list(j.read(offset))
    assert [r.offset for r in got] == list(range(offset, offset + 40))
    for a, b, c in zip(got, want, t.read(offset)):
        assert a.offset == b.offset and a.event_time == b.event_time
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.features, c.features)
    assert {int(r.label) for r in got} <= {1, 2, 3, 4}


def test_backpressure_drops_nothing():
    buf = TSt.BoundedBuffer(TSt.SyntheticStream(limit=64, seed=2),
                            capacity=4).start(0)
    try:
        deadline = time.monotonic() + 30
        while not (_value("bigdl_stream_backpressure_waits_total") or 0):
            assert time.monotonic() < deadline, "producer never blocked"
            time.sleep(0.01)
        assert buf.depth() <= 4
        got = [buf.get(timeout=30).offset for _ in range(64)]
        assert got == list(range(64))
        assert buf.get(timeout=30) is None
        assert _value("bigdl_stream_buffer_depth") == 0.0
    finally:
        thread = buf._thread
        buf.stop()
    assert not thread.is_alive()


def test_batches_equal_jax_and_the_tail_pends():
    kw = dict(feature_dim=8, n_classes=3, seed=1, limit=100)
    t = TSt.StreamDataSet(TSt.SyntheticStream(**kw), batch_size=16,
                          buffer_records=32)
    j = JSt.StreamDataSet(JSt.SyntheticStream(**kw), batch_size=16,
                          buffer_records=32)
    tb, jb = list(t.data()), list(j.data())
    assert len(tb) == len(jb) == 6
    for (tx, ty), (jx, jy) in zip(tb, jb):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for _ in range(2):
        t.note_batch_trained()
    assert t.stream_checkpoint_state() == {"offset": 32, "watermark": 31.0,
                                           "records": 32}
    # a fresh iterator restarts at the trained frontier
    x, _ = next(iter(t.data()))
    np.testing.assert_array_equal(x, tb[2][0])


def _mlp(N):
    return N.Sequential().add(N.Linear(16, 32)).add(N.ReLU()) \
        .add(N.Linear(32, 4)).add(N.LogSoftMax())


def _port_run(ck, iters, plan=None, monkeypatch=None):
    if plan:
        monkeypatch.setenv("BIGDL_TORCH_FAULT_PLAN", plan)
    Engine.reset()
    TRandom.RNG.set_seed(7)
    model = _mlp(TN)
    ds = TSt.StreamDataSet(TSt.SyntheticStream(feature_dim=16, n_classes=4,
                                               seed=3),
                           batch_size=32, buffer_records=64, audit_log=True)
    opt = TO.DistriOptimizer(model, ds, TN.ClassNLLCriterion(), 32,
                             wire_dtype="float32", device="cpu")
    opt.set_optim_method(TO.SGD(learningrate=0.5, momentum=0.9))
    opt.set_end_when(TO.Trigger.max_iteration(iters))
    opt.set_checkpoint(str(ck), TO.Trigger.several_iteration(5),
                       background=True)
    opt.optimize()
    if plan:
        monkeypatch.delenv("BIGDL_TORCH_FAULT_PLAN")
    return model, opt, ds


def test_the_offset_rides_the_checkpoint(tmp_path):
    model, opt, ds = _port_run(tmp_path / "ck", 5)
    assert ds.stream_checkpoint_state()["offset"] == 160
    directory = str(tmp_path / "ck")
    prefix = os.path.join(directory, TS.checkpoint_prefixes(directory)[-1])
    assert TS.read_checkpoint_stream(prefix)["offset"] == 160
    # the JAX package reads the same frontier from the port's files
    assert JS.read_checkpoint_stream(prefix)["offset"] == 160
    extra = TS.load_checkpoint(prefix, _mlp(TN), TO.SGD())
    assert extra["stream"] == {"offset": 160, "watermark": 159.0,
                               "records": 160}


def test_the_resume_is_exactly_once_and_matches_jax(tmp_path, monkeypatch):
    before = {t.ident for t in threading.enumerate()}
    ref, ref_opt, ref_ds = _port_run(tmp_path / "ref", 12)
    model, opt, ds = _port_run(tmp_path / "ck", 12, "step:8:raise",
                               monkeypatch)
    assert opt.retries == 1
    assert ds.stream_checkpoint_state()["offset"] == 12 * 32
    # the crashed attempt trained 6 and 7 past the checkpoint at 5; the
    # retry seeks back to offset 160 and trains them again
    flat = [o for s, e in ds.audit_log for o in range(s, e)]
    assert flat == list(range(224)) + list(range(160, 384))
    ref_flat = [o for s, e in ref_ds.audit_log for o in range(s, e)]
    assert ref_flat == list(range(384))
    for a, b in zip(T.leaves(model.params()), T.leaves(ref.params())):
        assert torch.equal(a, b)
    assert {t.ident for t in threading.enumerate()} <= before

    JRandom.RNG.set_seed(7)
    jm = _mlp(JN)
    jds = JSt.StreamDataSet(JSt.SyntheticStream(feature_dim=16, n_classes=4,
                                                seed=3),
                            batch_size=32, buffer_records=64)
    jo = JO.LocalOptimizer(jm, jds, JN.ClassNLLCriterion(), 32)
    jo.set_optim_method(JO.SGD(learningrate=0.5, momentum=0.9))
    jo.set_end_when(JO.Trigger.max_iteration(12)).optimize()
    assert jds.stream_checkpoint_state()["offset"] == 12 * 32
    for a, b in zip(T.leaves(model.params()), jax.tree.leaves(jm.params())):
        err = float(np.max(np.abs(a.detach().numpy() - np.asarray(b))))
        assert err <= TOL, err
