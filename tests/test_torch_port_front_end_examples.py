"""The port's front-end example scripts against the JAX examples, on
the CPU at small sizes (``python -m bigdl_tpu_torch.examples.<name>``
with ``--device cpu``):

- ``finetune_frozen_graph`` and ``train_from_tf_pipeline`` (the latter
  with ``--local``): the same Top-1 accuracy as the JAX example, on the
  same seeded weights; through ``DistriOptimizer`` (the port at world 1,
  JAX over its test mesh of 8 virtual devices) within 0.02.
- ``mnist_cnn``: with its Dropout at rate 0 in both packages, the same
  held-out loss and accuracy within 1e-5; with the example's Dropout
  (whose bits differ between the packages) both learn past chance.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine as TEngine

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_example(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + rel.replace("/", "_")[:-3], REPO / "examples" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def engines():
    JEngine.reset()
    TEngine.reset()
    yield
    JEngine.reset()
    TEngine.reset()


@pytest.mark.parametrize("distributed", [False, True])
def test_finetune_frozen_graph_accuracy_equals_jax(distributed, engines):
    from bigdl_tpu_torch.examples import finetune_frozen_graph as T

    J = _jax_example("tensorflow/finetune_frozen_graph.py")
    flag = ["--distributed"] if distributed else []
    JRandom.RNG.set_seed(0)
    want = J.main(["-e", "2"] + flag)
    TRandom.RNG.set_seed(0)
    got = T.main(["-e", "2", "--device", "cpu"] + flag)
    assert want > 0.5
    if distributed:
        assert abs(got - want) <= 0.02
    else:
        assert got == want


@pytest.mark.parametrize("local", [True, False])
def test_train_from_tf_pipeline_accuracy_equals_jax(local, engines):
    from bigdl_tpu_torch.examples import train_from_tf_pipeline as T

    J = _jax_example("tensorflow/train_from_tf_pipeline.py")
    flag = ["--local"] if local else []
    JRandom.RNG.set_seed(0)                 # the trainers' shuffles
    want = J.main(["-e", "2", "-n", "128"] + flag)
    JEngine.reset()
    TRandom.RNG.set_seed(0)
    got = T.main(["-e", "2", "-n", "128", "--device", "cpu"] + flag)
    assert want > 0.5
    if local:
        assert got == want
    else:
        assert abs(got - want) <= 0.02


def _mnist(monkeypatch, n):
    from bigdl_tpu_torch.examples import mnist_cnn as T

    J = _jax_example("keras/mnist_cnn.py")
    argv = ["--nb-epoch", "2", "-n", str(n)]
    JRandom.RNG.set_seed(0)
    seen = {}
    import bigdl_tpu.keras.models as JM

    real = JM.Sequential.evaluate

    def evaluate(self, *a, **k):
        seen["jax"] = real(self, *a, **k)
        return seen["jax"]

    monkeypatch.setattr(JM.Sequential, "evaluate", evaluate)
    monkeypatch.setattr(sys, "argv", ["mnist_cnn"] + argv)
    J.main()
    TRandom.RNG.set_seed(0)
    got = T.main(argv + ["--device", "cpu"])
    return got, seen["jax"]


def test_mnist_cnn_without_dropout_equals_jax(monkeypatch):
    import bigdl_tpu.keras.layers as JL
    import bigdl_tpu.nn as JN
    import bigdl_tpu_torch.keras.layers as TL
    import bigdl_tpu_torch.nn as TN

    monkeypatch.setattr(JL.Dropout, "build", lambda self, s: JN.Dropout(0.0))
    monkeypatch.setattr(TL.Dropout, "build", lambda self, s: TN.Dropout(0.0))
    (loss, acc), (jloss, jacc) = _mnist(monkeypatch, 1024)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert acc == jacc


def test_mnist_cnn_learns_in_both(monkeypatch):
    (loss, acc), (jloss, jacc) = _mnist(monkeypatch, 1024)
    assert acc > 0.2 and jacc > 0.2            # 10 classes: chance 0.1
    assert np.isfinite(loss) and np.isfinite(jloss)
