"""The classic Python-BigDL program through ``bigdl_torch``, the port's
compat shim, on the CPU.

``tests/test_bigdl_shim.py``'s cases, the program unchanged but for
``device="cpu"`` (``init_engine``, ``Optimizer``, the Keras ``Sequential`` and
LeNet's ``build_model``) and for ``forward``, which is torch's and takes
a tensor (the stateful ``update_output`` takes the numpy array).  The
classic training run's losses equal those of the same program written
against ``bigdl_tpu_torch`` directly, step for step."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.engine import Engine


@pytest.fixture(autouse=True)
def _engine():
    Engine.reset()
    yield
    Engine.reset()


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _data():
    rs = np.random.RandomState(0)
    x = rs.randn(256, 4).astype(np.float32)
    y = (1 + (x[:, 0] > 0)).astype(np.float32)
    return x, y


def _classic_run(layer, criterion, optimizer, common):
    """The canonical Python-BigDL program over the given modules."""
    common.init_engine(device="cpu")
    x, y = _data()
    from bigdl_tpu_torch.common import RandomGenerator

    RandomGenerator.RNG.set_seed(0)
    model = layer.Sequential().add(layer.Linear(4, 16)).add(layer.ReLU()) \
        .add(layer.Linear(16, 2)).add(layer.LogSoftMax())
    opt = optimizer.Optimizer(
        model=model, training_set=(x, y),
        criterion=criterion.ClassNLLCriterion(),
        optim_method=optimizer.SGD(learningrate=0.5),
        end_trigger=optimizer.MaxEpoch(5), batch_size=64,
        distributed=False, device="cpu")
    losses = _Losses()
    opt.set_train_summary(losses)
    trained = opt.optimize()
    return trained, [losses.loss[k] for k in sorted(losses.loss)]


def test_classic_imports_and_training():
    from bigdl_torch.nn import criterion as shim_criterion
    from bigdl_torch.nn import layer as shim_layer
    from bigdl_torch.optim import optimizer as shim_optimizer
    from bigdl_torch.util import common as shim_common

    trained, losses = _classic_run(shim_layer, shim_criterion,
                                   shim_optimizer, shim_common)
    x, y = _data()
    from bigdl_tpu_torch.optim.evaluator import predict_class

    acc = (predict_class(trained, x, device="cpu") == y.astype(int)).mean()
    assert acc > 0.95
    assert len(losses) == 5 * 4 and all(np.isfinite(losses))

    # the same program against the port directly
    import bigdl_tpu_torch.nn as TN
    import bigdl_tpu_torch.optim as TO

    class _Optim:
        Optimizer = TO.Optimizer
        SGD = TO.SGD

        @staticmethod
        def MaxEpoch(n):  # noqa: N802
            return TO.Trigger.max_epoch(n)

    class _Common:
        @staticmethod
        def init_engine(device):
            Engine.init(device=device)

    Engine.reset()
    _, direct = _classic_run(TN, TN, _Optim, _Common)
    assert losses == direct


def test_functional_model_spelling():
    from bigdl_torch.nn.layer import Input, Linear, Model, ReLU

    inp = Input()
    h = Linear(6, 8)(inp)
    r = ReLU()(h)
    out = Linear(8, 2)(r)
    model = Model(inp, out)
    x = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    assert tuple(model.forward(torch.from_numpy(x)).shape) == (3, 2)
    assert tuple(model.update_output(x).shape) == (3, 2)


def test_jtensor_and_sample():
    from bigdl_torch.util.common import JTensor, Sample

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    jt = JTensor.from_ndarray(a)
    np.testing.assert_array_equal(jt.to_ndarray(), a)
    s = Sample.from_ndarray(a, np.asarray([1.0]))
    np.testing.assert_array_equal(s.feature(), a)


def test_trigger_spellings():
    from bigdl_torch.optim.optimizer import (
        EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss,
        SeveralIteration, TriggerAnd, TriggerOr,
    )

    assert MaxEpoch(3)({"epoch": 4, "neval": 1, "epoch_finished": 3})
    assert not MaxEpoch(3)({"epoch": 2, "neval": 1, "epoch_finished": 1})
    assert MaxIteration(10)({"epoch": 1, "neval": 11, "epoch_finished": 0})
    assert SeveralIteration(5)({"epoch": 1, "neval": 6, "epoch_finished": 0})
    EveryEpoch()  # constructible
    state = {"epoch": 1, "neval": 11, "epoch_finished": 0, "loss": 0.1,
             "score": 0.9}
    assert MinLoss(0.5)(state) and MaxScore(0.5)(state)
    assert TriggerAnd(MaxIteration(10), MinLoss(0.5))(state)
    assert TriggerOr(MaxIteration(100), MinLoss(0.5))(state)


def test_extended_shim_import_paths():
    from bigdl_torch.nn.keras.topology import Sequential as KSequential
    from bigdl_torch.nn.keras.layer import Dense
    from bigdl_torch.keras.converter import model_from_json  # noqa: F401
    from bigdl_torch.models.lenet.lenet5 import build_model
    from bigdl_torch.dlframes.dl_classifier import (  # noqa: F401
        DLClassifier, DLClassifierModel, DLEstimator, DLModel,
    )

    m = build_model(class_num=10, device="cpu")
    out = m.forward(torch.ones((2, 28, 28)))
    assert tuple(out.shape) == (2, 10)

    km = KSequential(device="cpu")
    km.add(Dense(4, input_shape=(6,)))
    assert km.output_shape == (None, 4)


def test_tf_utils_shim():
    from bigdl_torch.util.tf_utils import (  # noqa: F401
        BigDLSessionImpl, TensorflowLoader, TensorflowSaver,
        TFTrainingSession, load_tf,
    )

    assert BigDLSessionImpl is TFTrainingSession


def test_the_shim_mirrors_bigdl_file_for_file():
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    jax_files = sorted(p.relative_to(root / "bigdl").as_posix()
                       for p in (root / "bigdl").rglob("*.py"))
    port_files = sorted(p.relative_to(root / "bigdl_torch").as_posix()
                        for p in (root / "bigdl_torch").rglob("*.py"))
    assert port_files == jax_files and len(jax_files) == 23


def test_the_shim_imports_neither_jax_nor_the_jax_packages():
    code = ("import sys\n"
            "import bigdl_torch.nn.layer, bigdl_torch.optim.optimizer, "
            "bigdl_torch.util.common\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'bigdl_tpu', 'bigdl')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_packaging_ships_the_host_source_and_the_port_mains():
    import importlib
    import pathlib
    import tomllib

    root = pathlib.Path(__file__).resolve().parents[1]
    doc = tomllib.loads((root / "pyproject.toml").read_text())
    data = doc["tool"]["setuptools"]["package-data"]["bigdl_tpu_torch"]
    for pattern in data:
        assert list((root / "bigdl_tpu_torch").glob(pattern)), pattern
    assert "csrc/host/*.cpp" in data
    scripts = doc["project"]["scripts"]
    for name in ("lenet", "resnet", "inception", "rnn"):
        target = scripts[f"bigdl-tpu-torch-{name}"]
        mod, fn = target.split(":")
        assert mod == f"bigdl_tpu_torch.models.{name}"
        assert callable(getattr(importlib.import_module(mod), fn))
    assert any(p.startswith("bigdl")
               for p in doc["tool"]["setuptools"]["packages"]["find"][
                   "include"])
