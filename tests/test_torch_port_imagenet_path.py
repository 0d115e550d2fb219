"""The TrainImageNet path end to end, on the CPU, against the JAX
package: ``train_imagenet_folder`` in both packages over the same BMP
folder (2 classes x 8 images, image size 32), a tiny conv/BN model
from the same seed, 2 epochs at batch 8, world 1 (JAX on a 1-device
mesh), with the ResNet recipe's schedule.  Through the f32 wire the
per-step losses agree within 1e-5 relative (measured: 6e-6); through
the bf16 wire (the default) within 1e-3 relative (measured: 1.5e-4):
a gradient element whose f32 value differs between the packages by
an ulp can round to the other bf16 neighbour, an error of 2^-8 of
that element, which the next steps carry.  The per-epoch Top1/Top5
agree within 1e-6.  The port's entry points (the CLI, ``train_lenet``)
run their checkpoints and ``DistriOptimizer`` here too."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.optim as JO
from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.config import config as j_config
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.models import train_util as JT
from bigdl_tpu.models.resnet import imagenet_recipe_optim as j_recipe
from bigdl_tpu.optim import distri_optimizer as JD
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.models import train_util as TT
from bigdl_tpu_torch.optim import distri_optimizer as TD
from bigdl_tpu_torch.utils import serializer as TS

from test_torch_port_vision import write_folder

LOSS_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
SCORE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _worlds(monkeypatch):
    """The port's world of 1 is made and ended per test; the JAX
    package's ``Engine`` gets a 1-device mesh for the test only."""
    Engine.reset()
    st = type(JEngine._state)()
    st.initialized = True
    st.mesh = JEngine.build_mesh({"data": 1}, devices=jax.devices()[:1])
    monkeypatch.setattr(JEngine, "_state", st)
    yield
    Engine.reset()


def _tiny(N, class_num):
    return N.Sequential() \
        .add(N.SpatialConvolution(3, 6, 3, 3, 2, 2, 1, 1)) \
        .add(N.SpatialBatchNormalization(6)).add(N.ReLU()) \
        .add(N.SpatialAveragePooling(16, 16, 1, 1, global_pooling=True)) \
        .add(N.Reshape([6])).add(N.Linear(6, class_num)).add(N.LogSoftMax())


class _Record:
    """Every Loss by step, and every validation value by method."""

    def __init__(self):
        self.loss, self.val = {}, {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value
        elif tag != "Throughput":
            self.val.setdefault(tag, []).append(value)

    def get_summary_trigger(self, name):
        return None


def _recording(monkeypatch, module, base):
    """Make ``module.DistriOptimizer`` record into a ``_Record``."""
    rec = _Record()

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_train_summary(rec).set_val_summary(rec)

    monkeypatch.setattr(module, "DistriOptimizer", Recording)
    return rec


def _recipe(recipe):
    """The ResNet recipe at a rate that moves a tiny model (the linear
    scaling gives 0.003 at batch 8): one warmup epoch, then MultiStep."""
    return lambda bs, ep, it: recipe(bs, n_epochs=ep, iterations_per_epoch=it,
                                     base_lr=0.4, warmup_epochs=1)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_train_imagenet_folder_matches_jax(tmp_path, monkeypatch, wire):
    # the JAX package's wire, for this test only: its config re-reads the
    # environment (refresh_from_env) and the old object comes back after
    monkeypatch.setenv("BIGDL_WIRE_DTYPE", wire)
    monkeypatch.setattr(j_config, "wire",
                        dataclasses.replace(j_config.wire, dtype=wire))
    monkeypatch.setenv("BIGDL_TORCH_WIRE_DTYPE", wire)
    root = write_folder(tmp_path / "data", classes=2, per_class=8, val=4,
                        sizes=((40, 52), (48, 36), (45, 45), (50, 40)))
    j_rec = _recording(monkeypatch, JO, JD.DistriOptimizer)
    JRandom.RNG.set_seed(5)
    JT.train_imagenet_folder(lambda class_num: _tiny(JN, class_num),
                             _recipe(j_recipe), root, 8, 2, image_size=32)
    t_rec = _recording(monkeypatch, TD, TD.DistriOptimizer)
    TRandom.RNG.set_seed(5)
    opt = TT.train_imagenet_folder(
        lambda class_num, device: _tiny(TN, class_num).to(device),
        _recipe(TR.imagenet_recipe_optim), root, 8, 2, image_size=32,
        checkpoint=str(tmp_path / "ck"), device="cpu")
    assert sorted(t_rec.loss) == sorted(j_rec.loss) == [1, 2, 3, 4]
    for n in j_rec.loss:
        j, t = j_rec.loss[n], t_rec.loss[n]
        assert np.isfinite(t) and abs(t - j) <= LOSS_REL_TOL[wire] * abs(j), \
            (n, t, j)
    assert set(t_rec.val) == set(j_rec.val) == {"Top1Accuracy",
                                                "Top5Accuracy"}
    for k in j_rec.val:
        assert len(t_rec.val[k]) == len(j_rec.val[k]) == 2
        np.testing.assert_allclose(t_rec.val[k], j_rec.val[k], rtol=0,
                                   atol=SCORE_TOL)
    assert opt.state["neval"] == 5 and opt.wire_dtype == wire
    assert TS.checkpoint_prefixes(str(tmp_path / "ck")) == [
        "checkpoint_2_3", "checkpoint_3_5"]


def test_resnet_cli_trains_from_a_folder(tmp_path):
    root = write_folder(tmp_path / "data", classes=2, per_class=4, val=2)
    opt = TR.main(["-f", root, "--depth", "18", "-b", "4", "-e", "1",
                   "--image-size", "32", "--checkpoint",
                   str(tmp_path / "ck"), "--device", "cpu"])
    assert isinstance(opt, TD.DistriOptimizer) and opt.state["neval"] == 3
    assert opt.state["score"] is not None
    (prefix,) = TS.checkpoint_prefixes(str(tmp_path / "ck"))
    assert TS.verify_checkpoint(os.path.join(str(tmp_path / "ck"),
                                             prefix))[0]


@pytest.mark.parametrize("distributed", [True, False])
def test_train_lenet_checkpoints_and_distributes(tmp_path, distributed):
    model, lopt = TL.train_lenet(batch_size=512, max_epoch=1,
                                 learning_rate=0.1,
                                 checkpoint_path=str(tmp_path / "lenet"),
                                 distributed=distributed, device="cpu")
    assert isinstance(lopt, TD.DistriOptimizer) == distributed
    assert lopt.state["epoch"] == 2 and lopt.state["score"] > 0.1
    (prefix,) = TS.checkpoint_prefixes(str(tmp_path / "lenet"))
    back = TS.load_module(os.path.join(str(tmp_path / "lenet"),
                                       prefix + ".model"))
    for a, b in zip(back.parameters(), model.parameters()):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())


def test_new_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    root = write_folder(tmp_path / "data", classes=2, per_class=2, val=1)
    x = np.zeros((4, 3, 8, 8), np.float32)
    y = np.ones(4, np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: Engine.init(),
             lambda: TD.DistriOptimizer(_tiny(TN, 2), (x, y),
                                        TN.ClassNLLCriterion(), 4),
             lambda: TR.main(["-f", root, "-b", "2"]),
             lambda: TT.train_imagenet_folder(
                 lambda class_num, device: _tiny(TN, class_num), None,
                 root, 2, 1),
             lambda: TL.train_lenet(distributed=True)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        assert not Engine.is_initialized()
