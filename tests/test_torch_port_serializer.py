"""The port's serializer and checkpoints against the JAX package, on the
CPU.

Specs and module npz files are equal between the packages (ResNet-18
fused and unfused, LeNet-5, the PTB LM), and each package loads the
other's.  A ``LocalOptimizer`` checkpoint of a small conv/BN/Linear
model trained with SGD momentum, written by one package, loads into the
other: parameters, BN state, optimizer state and ``extra`` equal
(exactly; they are copied), and one more step gives the writer's own
next loss within 1e-5 (the limit of the port's other trainer parity
tests).  ``verify_checkpoint`` refuses a file with one byte changed and
``load_latest_checkpoint`` then falls back to the older pair."""

import os

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.models.lenet import build_lenet5 as j_lenet
from bigdl_tpu.models.resnet import build_resnet_imagenet as j_resnet
from bigdl_tpu.models.rnn import build_ptb_lm as j_ptb
from bigdl_tpu.nn.fused import fuse_conv_bn as j_fuse
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.models.lenet import build_lenet5 as t_lenet
from bigdl_tpu_torch.models.resnet import build_resnet_imagenet as t_resnet
from bigdl_tpu_torch.models.rnn import build_ptb_lm as t_ptb
from bigdl_tpu_torch.models.transformer import build_transformer_lm
from bigdl_tpu_torch.nn.fused import fuse_conv_bn as t_fuse
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

LOSS_TOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _assert_trees_equal(t_tree, j_tree):
    tp = T.leaves_with_paths(t_tree)
    jp = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(tp) == len(jp)
    for (path, a), (jpath, b) in zip(tp, jp):
        assert "/".join(path) == "/".join(str(k.key) for k in jpath)
        np.testing.assert_array_equal(_np(a), np.asarray(b))


MODELS = {
    "resnet18": (lambda: j_resnet(18, 7), lambda: t_resnet(18, 7,
                                                           device="cpu")),
    "resnet18_fused": (lambda: j_fuse(j_resnet(18, 7)),
                       lambda: t_fuse(t_resnet(18, 7, device="cpu"))),
    "lenet": (j_lenet, lambda: t_lenet(device="cpu")),
    "ptb": (lambda: j_ptb(40, 8, 12), lambda: t_ptb(40, 8, 12,
                                                    device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_specs_and_module_files_match_jax(tmp_path, name):
    j_build, t_build = MODELS[name]
    JRandom.RNG.set_seed(3)
    jm = j_build()
    TRandom.RNG.set_seed(3)
    tm = t_build()
    assert TS.module_to_spec(tm) == JS.module_to_spec(jm)
    JS.save_module(jm, str(tmp_path / "j"))
    assert TS.save_module(tm, str(tmp_path / "t")).endswith("t.npz")
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    t_from_j = TS.load_module(str(tmp_path / "j"))
    assert TS.module_to_spec(t_from_j) == TS.module_to_spec(tm)
    _assert_trees_equal(t_from_j.params(), jm.params())
    _assert_trees_equal(t_from_j.state(), jm.state())
    j_from_t = JS.load_module(str(tmp_path / "t.npz"))
    _assert_trees_equal(tm.params(), j_from_t.params())


def test_what_cannot_be_serialized_raises(tmp_path):
    lm = build_transformer_lm(48, dim=32, n_head=4, n_layer=1, max_len=16,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="cannot be serialized"):
        TS.save_module(lm, str(tmp_path / "lm"))
    with pytest.raises(NotImplementedError, match="protobuf"):
        TS.save_module(t_lenet(device="cpu"), str(tmp_path / "m.bigdl"))
    with pytest.raises(KeyError, match="unknown module class"):
        TS.spec_to_module({"class": "NoSuchLayer", "config": {}})


def _small(N):
    return N.Sequential() \
        .add(N.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(N.SpatialBatchNormalization(4)).add(N.ReLU()) \
        .add(N.SpatialAveragePooling(8, 8, 1, 1, global_pooling=True)) \
        .add(N.Reshape([4])).add(N.Linear(4, 3)).add(N.LogSoftMax())


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(16, 3, 8, 8).astype(np.float32),
            (rs.randint(0, 3, 16) + 1).astype(np.float32))


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _trainer(pkg, seed=4):
    x, y = _data()
    if pkg == "jax":
        JRandom.RNG.set_seed(seed)
        opt = JLocal(_small(JN), JArray(x, y, 8, shuffle=False),
                     JN.ClassNLLCriterion(), 8)
        opt.set_optim_method(JO.SGD(learningrate=0.1, momentum=0.9))
    else:
        TRandom.RNG.set_seed(seed)
        opt = TO.LocalOptimizer(_small(TN), TArray(x, y, 8, shuffle=False),
                                TN.ClassNLLCriterion(), 8, device="cpu")
        opt.set_optim_method(TO.SGD(learningrate=0.1, momentum=0.9))
    losses = _Losses()
    opt.set_train_summary(losses)
    return opt, losses


def _resume(opt, extra):
    for k in ("epoch", "neval", "epoch_neval0"):
        opt.state[k] = extra[k]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_local_checkpoint_loads_across_packages(tmp_path, writer):
    reader = "torch" if writer == "jax" else "jax"
    w, w_losses = _trainer(writer)
    Trig = JO.Trigger if writer == "jax" else TO.Trigger
    w.set_end_when(Trig.max_epoch(1)).set_checkpoint(str(tmp_path),
                                                     Trig.every_epoch())
    w.optimize()
    (prefix,) = [os.path.join(str(tmp_path), p) for p in
                 (JS if writer == "jax" else TS).checkpoint_prefixes(
                     str(tmp_path))]
    assert os.path.basename(prefix) == "checkpoint_2_3"
    r, r_losses = _trainer(reader, seed=99)
    load = (TS if reader == "torch" else JS).load_checkpoint
    extra = load(prefix, r.model, r.optim_method)
    assert extra["epoch"] == 2 and extra["neval"] == 3
    assert extra["epoch_neval0"] == 3
    assert extra["topology"]["shard_layout"] == "tree"
    tm, jm = (r.model, w.model) if reader == "torch" else (w.model, r.model)
    _assert_trees_equal(tm.params(), jm.params())
    _assert_trees_equal(tm.state(), jm.state())
    # the optimizer state as each package keeps it, by the npz keys
    topt = (r if reader == "torch" else w).optim_method
    jopt = (w if reader == "torch" else r).optim_method
    if reader == "torch":
        t_arrays = {k: v for k, v in
                    TO.OptimMethod._unflatten_state(
                        JO.OptimMethod.get_state_arrays(jopt)).items()}
        got = {k: v for k, v in topt.state.items()}
        assert set(got) == set(t_arrays)
        for k in ("neval", "epoch", "lr_scale", "lr_decay"):
            np.testing.assert_array_equal(_np(got[k]), _np(t_arrays[k]))
        _assert_trees_equal(got["velocity"], jopt.state["velocity"])
    else:
        j_arrays = jopt.get_state_arrays()
        t_arrays = topt.get_state_arrays()
        assert set(j_arrays) == set(t_arrays)
        for k in j_arrays:
            np.testing.assert_array_equal(j_arrays[k], t_arrays[k])
    _resume(r, extra)
    RTrig = JO.Trigger if reader == "jax" else TO.Trigger
    r.set_end_when(RTrig.max_iteration(4)).optimize()
    w.set_end_when(Trig.max_iteration(4)).optimize()
    assert sorted(r_losses.loss) == [3, 4]
    for n in (3, 4):
        assert abs(r_losses.loss[n] - w_losses.loss[n]) <= LOSS_TOL, n


def test_verify_refuses_a_changed_byte_and_falls_back(tmp_path):
    opt, _ = _trainer("torch")
    opt.set_end_when(TO.Trigger.max_epoch(2)).set_checkpoint(
        str(tmp_path), TO.Trigger.every_epoch())
    opt.optimize()
    old, new = [os.path.join(str(tmp_path), p)
                for p in TS.checkpoint_prefixes(str(tmp_path))]
    assert os.path.basename(new) == "checkpoint_3_5"
    for p in (old, new):
        assert TS.verify_checkpoint(p) == (True, "ok")
        assert JS.verify_checkpoint(p)[0]
        assert TS.read_checkpoint_topology(p)["step"] in (3, 5)
    path = new + ".optim.npz"
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    ok, reason = TS.verify_checkpoint(new)
    assert not ok and "checksum mismatch" in reason
    m, _ = _trainer("torch", seed=7)
    extra = TS.load_latest_checkpoint(str(tmp_path), m.model,
                                      m.optim_method)
    assert extra["neval"] == 3
    os.remove(old + ".manifest.json")
    open(old + ".model.npz.tmp.npz", "wb").write(b"")
    ok, reason = TS.verify_checkpoint(old)
    assert not ok and "interrupted" in reason
    with pytest.raises(TS.CheckpointIntegrityError):
        TS.load_latest_checkpoint(str(tmp_path), m.model, m.optim_method)


def test_keep_last_and_optim_method_files(tmp_path):
    opt, _ = _trainer("torch")
    opt.set_end_when(TO.Trigger.max_epoch(3)).set_checkpoint(
        str(tmp_path / "ck"), TO.Trigger.every_epoch(), keep_last=2)
    opt.optimize()
    assert TS.checkpoint_prefixes(str(tmp_path / "ck")) == [
        "checkpoint_3_5", "checkpoint_4_7"]
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        f"checkpoint_{t}.{s}" for t in ("3_5", "4_7")
        for s in ("model.npz", "optim.npz", "manifest.json"))
    method = opt.optim_method
    method.save(str(tmp_path / "sgd"))
    back = TO.OptimMethod.load(str(tmp_path / "sgd"))
    assert type(back) is TO.SGD and back.momentum == 0.9
    assert set(back.state) == set(method.state)
    assert set(back.state["velocity"]) == {str(i) for i in range(7)}
    a = back.get_state_arrays()
    b = method.get_state_arrays()
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="no hyperparameters"):
        TO.OptimMethod.load(str(tmp_path / "ck" / "checkpoint_4_7.optim"))
    with pytest.raises(NotImplementedError, match="background"):
        opt.set_checkpoint(str(tmp_path), background=True)
