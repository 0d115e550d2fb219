"""The last four example scripts of the port
(``bigdl_tpu_torch/examples/{train_ptb_lstm, train_cifar_resnet,
finetune_frozen_backbone, dl_classifier_example}.py``) against the JAX
examples they follow (``examples/ptb``, ``examples/imageclassification``,
``examples/dlframes``), on the CPU at small sizes, each package from
the same seed (the seeded initializers draw JAX's numbers).

Each run's training losses (every trainer the script builds, read
through a recording train summary) agree within 1e-5 of the JAX run's
and so does what the script reports (perplexity, Top-1, the backbone's
fine-tuned accuracy, the DataFrame's train accuracy);
``finetune_frozen_backbone`` keeps its backbone bit-identical (both
scripts assert it) and clears JAX's ``> 0.9``
(``tests/test_examples.py``).  It runs at ``--learning-rate 0.1``: at
the default 0.5 the first phase's loss spikes past 9 and the two
packages' f32 rounding grows to 7e-5 by step 12 (both still reach
Top-1 1.0); at 0.1 every loss agrees within 2e-7.
"""

import importlib.util
import pathlib
import re
import sys

import pytest

from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.optim import distri_optimizer as JD
from bigdl_tpu.optim import optimizer as JO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine as TEngine
from bigdl_tpu_torch.optim import distri_optimizer as TD
from bigdl_tpu_torch.optim import optimizer as TO

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


class _Rec:
    def __init__(self, out):
        self.out = out

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.out.append(float(value))

    def get_summary_trigger(self, name):
        return None


@pytest.fixture
def losses(monkeypatch):
    """Every trainer's losses, by package."""
    out = {"jax": [], "torch": []}
    for pkg, mods in (("jax", (JO.LocalOptimizer, JD.DistriOptimizer)),
                      ("torch", (TO.LocalOptimizer, TD.DistriOptimizer))):
        for cls in mods:
            def optimize(self, _real=cls.optimize, _out=out[pkg]):
                if self.train_summary is None:
                    self.set_train_summary(_Rec(_out))
                return _real(self)
            monkeypatch.setattr(cls, "optimize", optimize)
    JEngine.reset()
    TEngine.reset()
    yield out
    JEngine.reset()
    TEngine.reset()


def _jax_example(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + rel.replace("/", "_")[:-3], REPO / "examples" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(rel, argv, monkeypatch):
    """A JAX example whose ``main`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [rel] + argv)
    return _jax_example(rel).main()


def _agree(losses, first=None):
    j, t = losses["jax"], losses["torch"]
    assert len(t) == len(j) > 0
    for k, (a, b) in enumerate(zip(t, j)):
        if first is None or k < first:
            assert abs(a - b) <= TOL * max(1.0, abs(b)), (k, a, b)
    return max(abs(a - b) for a, b in zip(t, j))


def test_train_ptb_lstm(losses, monkeypatch, capsys):
    from bigdl_tpu_torch.examples import train_ptb_lstm as T

    argv = ["-e", "1", "--num-steps", "20", "-b", "64"]
    JRandom.RNG.set_seed(0)
    _jax_main("ptb/train_ptb_lstm.py", argv, monkeypatch)
    want = float(re.search(r"final perplexity: (\S+)",
                           capsys.readouterr().out).group(1))
    TRandom.RNG.set_seed(0)
    got = T.main(argv + ["--device", "cpu"])
    _agree(losses)
    assert round(got, 2) == pytest.approx(want, abs=0.011)


def test_train_cifar_resnet(losses, monkeypatch):
    from bigdl_tpu_torch.examples import train_cifar_resnet as T

    argv = ["--depth", "8", "-b", "256", "-e", "1"]
    JRandom.RNG.set_seed(0)
    _jax_main("imageclassification/train_cifar_resnet.py", argv, monkeypatch)
    TRandom.RNG.set_seed(0)
    got = T.main(argv + ["--device", "cpu"])
    _agree(losses)
    assert len(losses["torch"]) == 8
    # the same synthetic task, number for number
    J = _jax_example("imageclassification/train_cifar_resnet.py")
    (jx, jy), (jvx, jvy) = J.synthetic_cifar()
    (tx, ty), (tvx, tvy) = T.synthetic_cifar()
    assert (jx == tx).all() and (jvy == tvy).all()
    assert 0.0 <= got <= 1.0


def test_finetune_frozen_backbone(losses):
    from bigdl_tpu_torch.examples import finetune_frozen_backbone as T

    J = _jax_example("imageclassification/finetune_frozen_backbone.py")
    argv = ["-e", "5", "--learning-rate", "0.1"]
    JRandom.RNG.set_seed(0)
    want = J.main(argv)
    TRandom.RNG.set_seed(0)
    got = T.main(argv + ["--device", "cpu"])
    _agree(losses)
    assert len(losses["torch"]) == 80         # the head swap took
    assert got > 0.9 and want > 0.9
    assert abs(got - want) <= TOL


def test_dl_classifier_example(losses, monkeypatch, capsys):
    from bigdl_tpu_torch.examples import dl_classifier_example as T

    JRandom.RNG.set_seed(0)
    _jax_main("dlframes/dl_classifier_example.py", [], monkeypatch)
    want = float(re.search(r"train accuracy: (\S+)",
                           capsys.readouterr().out).group(1))
    TRandom.RNG.set_seed(0)
    got = T.main(["--device", "cpu"])
    _agree(losses)
    assert round(got, 3) == pytest.approx(want, abs=0.0011) and got > 0.9


def test_an_item_assigned_to_modules_replaces_the_child():
    """``model.modules[1] = head`` (the fine-tune script's head swap)
    changes the model, as JAX's list does; the port's ``modules`` was a
    copy, and the swap silently kept the old head."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn as TN

    m = TN.Sequential().add(TN.Linear(3, 4)).add(TN.Linear(4, 2))
    new = TN.Linear(4, 5)
    m.modules[1] = new
    assert m.modules[1] is new and len(m.modules) == 2
    x = torch.from_numpy(np.ones((2, 3), np.float32))
    assert tuple(m(x).shape) == (2, 5)
    m.modules.append(TN.ReLU())
    del m.modules[0]
    assert [type(c).__name__ for c in m.modules] == ["Linear", "ReLU"]
    assert sorted(m.params()) == ["0", "1"]
