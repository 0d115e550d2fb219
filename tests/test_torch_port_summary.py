"""The port's TensorBoard summaries (``visualization/summary.py``)
against the JAX package's, on the CPU.

- ``crc32c`` and the masked crc are equal on random bytes (exactly).
- Each package reads the other's event files: scalars (value equal as
  f32) and histograms (every field equal).
- A ``LocalOptimizer`` run with a ``TrainSummary`` (the "Parameters"
  trigger set) and a ``ValidationSummary`` writes the JAX run's tag
  set, each tag at the same steps, and Loss within 1e-5 of JAX's.
"""

import os

import numpy as np
import pytest

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.visualization import summary as JV
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.visualization import summary as TV

LOSS_TOL = 1e-5


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000])
def test_crc32c_equals_jax(n):
    data = np.random.RandomState(n).bytes(n)
    assert TV.crc32c(data) == JV.crc32c(data)
    assert TV._masked_crc(data) == JV._masked_crc(data)
    # the Castagnoli check value
    assert TV.crc32c(b"123456789") == 0xE3069283


def _tags(log_dir):
    """{tag: sorted steps} over every event file of ``log_dir``."""
    out = {}
    for f in sorted(os.listdir(log_dir)):
        if "tfevents" not in f:
            continue
        for step, msg in TV._iter_summary_values(os.path.join(log_dir, f)):
            k, pos = TV._read_varint(msg, 0)
            ln, pos = TV._read_varint(msg, pos)
            tag = bytes(msg[pos:pos + ln]).decode()
            out.setdefault(tag, []).append(step)
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    w_mod, r_mod = (TV, JV) if writer == "port" else (JV, TV)
    rs = np.random.RandomState(3)
    train = w_mod.TrainSummary(str(tmp_path), "app")
    values = rs.randn(5).astype(np.float64)
    for step, v in enumerate(values, start=1):
        train.add_scalar("Loss", v, step)
    hist = rs.randn(257).astype(np.float32)
    train.add_histogram("0/weight", hist, 3)
    train.add_resilience(4, nonfinite_skips=1, retries=2)
    val = w_mod.ValidationSummary(str(tmp_path), "app")
    val.add_scalar("Top1Accuracy", 0.75, 8)
    train.close()
    val.close()

    r_train = r_mod.TrainSummary(str(tmp_path), "app")
    r_val = r_mod.ValidationSummary(str(tmp_path), "app")
    try:
        got = r_train.read_scalar("Loss")
        assert [s for s, _ in got] == [1, 2, 3, 4, 5]
        np.testing.assert_array_equal([v for _, v in got],
                                      values.astype(np.float32))
        assert r_train.read_scalar("NonFiniteSkips") == [(4, 1.0)]
        assert r_train.read_scalar("RetryCount") == [(4, 2.0)]
        assert r_val.read_scalar("Top1Accuracy") == [(8, 0.75)]
        [(step, h)] = r_train.read_histogram("0/weight")
        [(_, want)] = w_mod.TrainSummary(
            str(tmp_path), "app").read_histogram("0/weight")
        assert step == 3 and h == want
        assert h["num"] == 257 and len(h["bucket"]) == 30
    finally:
        r_train.close()
        r_val.close()


def _mlp(N):
    return N.Sequential().add(N.Linear(6, 12)).add(N.Tanh()) \
        .add(N.Linear(12, 3)).add(N.LogSoftMax())


def _run(N, O, R, Arr, V, log_dir, **kw):
    rs = np.random.RandomState(0)
    x = rs.randn(64, 6).astype(np.float32)
    y = (rs.randint(0, 3, 64) + 1).astype(np.float32)
    R.RNG.set_seed(5)
    model = _mlp(N)
    opt = O.LocalOptimizer(model, Arr(x, y, 16), N.ClassNLLCriterion(), 16,
                           **kw)
    opt.set_optim_method(O.SGD(learningrate=0.3, momentum=0.9))
    opt.set_end_when(O.Trigger.max_epoch(2))
    train = V.TrainSummary(log_dir, "mlp")
    train.set_summary_trigger("Parameters", O.Trigger.several_iteration(3))
    val = V.ValidationSummary(log_dir, "mlp")
    opt.set_train_summary(train).set_val_summary(val)
    opt.set_validation(O.Trigger.every_epoch(), (x, y),
                       [O.Top1Accuracy(), O.Loss()])
    R.RNG.set_seed(9)
    opt.optimize()
    train.close()
    val.close()
    return train, val


def test_local_optimizer_writes_the_jax_tags(tmp_path):
    t_train, t_val = _run(TN, TO, TRandom, TArray, TV, str(tmp_path / "t"),
                          device="cpu")
    j_train, j_val = _run(JN, JO, JRandom, JArray, JV, str(tmp_path / "j"))
    t_tags, j_tags = _tags(t_train.log_dir), _tags(j_train.log_dir)
    assert t_tags == j_tags
    assert {"Loss", "Throughput", "0/weight", "0/bias", "2/weight",
            "2/bias"} == set(t_tags)
    assert t_tags["0/weight"] == [4, 7]
    assert _tags(t_val.log_dir) == _tags(j_val.log_dir) == {
        "Top1Accuracy": [5, 9], "Loss": [5, 9]}
    t_loss = [v for _, v in t_train.read_scalar("Loss")]
    j_loss = [v for _, v in j_train.read_scalar("Loss")]
    assert len(t_loss) == len(j_loss) == 8
    assert max(abs(a - b) for a, b in zip(t_loss, j_loss)) <= LOSS_TOL
    for (_, a), (_, b) in zip(t_train.read_histogram("2/weight"),
                              j_train.read_histogram("2/weight")):
        assert a["num"] == b["num"] == 36
        assert abs(a["sum"] - b["sum"]) <= LOSS_TOL
