"""BASELINE config 3 on the CPU: Inception and VGG through the Caffe
files and ``DistriOptimizer``, against the JAX package.

- A tiny Inception-v1 (``tests/test_caffe_training.py``'s, no dropout)
  and a tiny VGG are built in JAX from a seed, turned into graphs,
  written by JAX's ``CaffePersister`` and loaded by both packages'
  ``CaffeLoader``; then three ``DistriOptimizer`` steps at world 1 (JAX
  on a 1-device mesh, the f32 wire): losses and parameters within 1e-5
  relative.
- ``build_inception_v1``, ``build_inception_v2``, ``build_vgg16``,
  ``build_vgg19`` and ``build_vgg_cifar`` at full width: the same leaf
  paths and shapes as JAX's, from a seed the same weights; on JAX's
  weights the full Inception-v1's and Inception-v2's forwards at batch
  1 within 1e-4 relative (v2 in eval and in training mode, with the
  running statistics it leaves), the CIFAR VGG's at 32x32 within 1e-5.
- ``Poly`` and ``inception_recipe_optim`` give JAX's rates, and ``Poly``
  survives ``OptimMethod.save``/``load``.
- ``python -m bigdl_tpu_torch.models.inception`` trains from an image
  folder and on the synthetic task on ``--device cpu``, and raises
  without a GPU otherwise.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import ArrayDataSet as JArray
from bigdl_tpu.engine import Engine as JEngine
from bigdl_tpu.models import inception as JI
from bigdl_tpu.models import vgg as JV
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.utils import caffe as JC
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models import inception as TI
from bigdl_tpu_torch.models import vgg as TV
from bigdl_tpu_torch.optim import distri_optimizer as TD
from bigdl_tpu_torch.utils import caffe as TC
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_port_vision import write_folder

TOL = 1e-5
FULL_FWD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _port_world():
    """Each test makes (and ends) its own world of 1."""
    Engine.reset()
    yield
    Engine.reset()


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _tiny_inception():
    conv1 = JN.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1).set_name("conv1")
    return JN.Sequential().add(conv1).add(JN.ReLU()) \
        .add(JN.SpatialMaxPooling(2, 2, 2, 2).ceil().set_name("pool1")) \
        .add(JN.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1")) \
        .add(JI.inception_layer_v1(16, [[8], [8, 12], [4, 6], [6]],
                                   "inc_a/")) \
        .add(JI.inception_layer_v1(32, [[12], [8, 16], [4, 8], [8]],
                                   "inc_b/")) \
        .add(JN.SpatialAveragePooling(8, 8, 1, 1).set_name("pool5")) \
        .add(JN.Reshape([44])) \
        .add(JN.Linear(44, 5).set_name("fc"))


def _tiny_vgg():
    m = JN.Sequential()
    for n_in, n_out, convs in ((3, 8, 2), (8, 16, 2), (16, 32, 3)):
        for i in range(convs):
            m.add(JN.SpatialConvolution(n_in if i == 0 else n_out, n_out,
                                        3, 3, 1, 1, 1, 1)).add(JN.ReLU())
        m.add(JN.SpatialMaxPooling(2, 2, 2, 2))
    return m.add(JN.Reshape([32 * 2 * 2])).add(JN.Linear(32 * 2 * 2, 64)) \
        .add(JN.ReLU()).add(JN.Linear(64, 5))


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


@pytest.mark.parametrize("which", ["inception", "vgg"])
def test_loaded_graph_trains_as_jax_does(tmp_path, which):
    JRandom.RNG.set_seed(13)
    g = (_tiny_inception if which == "inception" else _tiny_vgg)() \
        .to_graph().evaluate()
    proto, model = str(tmp_path / "n.prototxt"), str(tmp_path / "n.caffemodel")
    JC.CaffePersister.save(g, proto, model, input_shape=(3, 16, 16))
    jg = JC.CaffeLoader(proto, model).load()
    tg = TC.CaffeLoader(proto, model, device="cpu").load()
    for a, b in zip(T.leaves_with_paths(tg.params()),
                    T.leaves_with_paths(jg.params())):
        assert a[0] == b[0]
        np.testing.assert_array_equal(_np(a[1]), _np(b[1]))
    rs = np.random.RandomState(1)
    x = rs.rand(48, 3, 16, 16).astype(np.float32)
    y = (rs.randint(0, 5, 48) + 1).astype(np.float32)

    jg.training()
    jo = JDistri(jg, JArray(x, y, 16, shuffle=False),
                 JN.CrossEntropyCriterion(), 16,
                 mesh=JEngine.build_mesh({"data": 1},
                                         devices=jax.devices()[:1]),
                 wire_dtype="float32")
    jo.set_optim_method(JO.SGD(learningrate=0.2, momentum=0.9))
    jo.set_end_when(JO.Trigger.max_iteration(3))
    jl = _Losses()
    jo.set_train_summary(jl)
    jo.optimize()

    to = TO.DistriOptimizer(tg, TArray(x, y, 16, shuffle=False),
                            TN.CrossEntropyCriterion(), 16,
                            wire_dtype="float32", device="cpu")
    to.set_optim_method(TO.SGD(learningrate=0.2, momentum=0.9))
    to.set_end_when(TO.Trigger.max_iteration(3))
    tl = _Losses()
    to.set_train_summary(tl)
    to.optimize()

    j_loss = [jl.loss[k] for k in sorted(jl.loss)]
    t_loss = [tl.loss[k] for k in sorted(tl.loss)]
    assert len(t_loss) == len(j_loss) == 3
    for a, b in zip(t_loss, j_loss):
        assert abs(a - b) <= TOL * abs(b), (t_loss, j_loss)
    assert t_loss[-1] != t_loss[0]
    for a, b in zip(T.leaves(tg.params()), jax.tree.leaves(jg.params())):
        b = np.asarray(b)
        err = float(np.max(np.abs(_np(a) - b)))
        assert err <= TOL * max(float(np.max(np.abs(b))), 1e-30)


def _shapes(tree):
    return [("/".join(p), tuple(np.shape(v)))
            for p, v in T.leaves_with_paths(tree)]


_BUILDERS = {
    "inception_v1": (JI.build_inception_v1, TI.build_inception_v1, 1000),
    "inception_v2": (JI.build_inception_v2, TI.build_inception_v2, 1000),
    "vgg16": (JV.build_vgg16, TV.build_vgg16, 1000),
    "vgg19": (JV.build_vgg19, TV.build_vgg19, 1000),
    "vgg_cifar": (JV.build_vgg_cifar, TV.build_vgg_cifar, 10)}


@pytest.mark.parametrize("which", list(_BUILDERS))
def test_full_width_models_match_jax(which):
    jbuild, tbuild, classes = _BUILDERS[which]
    JRandom.RNG.set_seed(17)
    jm = jbuild(classes)
    TRandom.RNG.set_seed(17)
    tm = tbuild(classes, device="cpu")
    assert _shapes(tm.params()) == _shapes(jax.tree.map(np.asarray,
                                                        jm.params()))
    assert _shapes(tm.state()) == _shapes(jax.tree.map(np.asarray,
                                                       jm.state()))
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def _centred_err(got, want):
    """max |Δ| over max |y| of the log-probabilities less their mean per
    row: the logits' spread, which a LogSoftMax's -log(classes) offset
    would otherwise hide."""
    got = got - got.mean(axis=-1, keepdims=True)
    want = want - want.mean(axis=-1, keepdims=True)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def _forward_both(jm, tm, x, training):
    """(JAX output, JAX new state, port output, port new state) of one
    forward on the JAX model's weights and running statistics."""
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))
    jy, jst = jm.apply(jm.params(), jm.state(), jnp.asarray(x),
                       training=training)
    tm.train(training)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    return np.asarray(jy), jax.tree.map(np.asarray, jst), ty.numpy(), \
        tm.state()


def _check_state(got, want):
    got, want = T.leaves_with_paths(got), T.leaves_with_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        err = float(np.max(np.abs(_np(a) - b)))
        assert err <= FULL_FWD_TOL * float(np.max(np.abs(b))), (path, err)


@pytest.mark.parametrize("training", [False, True])
def test_full_inception_v2_forward_matches_jax(training):
    """Every pool, branch and grid reduction of BN-Inception at 224x224,
    in eval mode and in training mode (batch statistics, and the running
    statistics it leaves)."""
    JRandom.RNG.set_seed(23)
    jm = JI.build_inception_v2(1000)
    tm = TI.build_inception_v2(1000, device="cpu")
    x = np.random.RandomState(2).randn(1, 3, 224, 224).astype(np.float32)
    jy, jst, ty, tst = _forward_both(jm, tm, x, training)
    assert ty.shape == jy.shape == (1, 1000)
    assert _centred_err(ty, jy) <= FULL_FWD_TOL
    _check_state(tst, jst)


@pytest.mark.parametrize("training", [False, True])
def test_vgg_cifar_forward_matches_jax(training):
    """The CIFAR VGG at 32x32 (conv + BN blocks, the BN head); in
    training mode without a seed both packages' dropout is the
    identity, so the outputs compare.  The full-width limit: batch
    statistics over 4 samples (16 values a channel in the last block)
    scale up f32 rounding, and each package alone reads about 1.5e-5
    off a float64 run of the port."""
    JRandom.RNG.set_seed(29)
    jm = JV.build_vgg_cifar(10)
    tm = TV.build_vgg_cifar(10, device="cpu")
    x = np.random.RandomState(3).randn(4, 3, 32, 32).astype(np.float32)
    jy, jst, ty, tst = _forward_both(jm, tm, x, training)
    assert ty.shape == jy.shape == (4, 10)
    assert _centred_err(ty, jy) <= FULL_FWD_TOL
    _check_state(tst, jst)


def test_full_inception_v1_forward_matches_jax():
    JRandom.RNG.set_seed(19)
    jm = JI.build_inception_v1(1000, has_dropout=False).evaluate()
    tm = TI.build_inception_v1(1000, has_dropout=False, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    x = np.random.RandomState(0).randn(1, 3, 224, 224).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tm.evaluate()(torch.from_numpy(x)).numpy()
    err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    assert err <= FULL_FWD_TOL


def test_poly_and_the_inception_recipe_match_jax(tmp_path):
    t = TI.inception_recipe_optim(32, 2, 5)
    j = JI.inception_recipe_optim(32, 2, 5)
    for k in ("learningrate", "momentum", "dampening", "weightdecay"):
        assert getattr(t, k) == pytest.approx(getattr(j, k), rel=0, abs=0)
    assert t.learningrate_schedule.max_iteration == 10
    assert t.learningrate_schedule.power == 0.5
    for n in (0, 1, 3, 9, 10, 15):
        got = float(t.current_rate({"neval": torch.tensor(float(n))}))
        want = float(j.learningrate_schedule.rate(
            j.learningrate, {"neval": jnp.asarray(float(n))}))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert float(TO.Poly(2.0, 4).rate(1.0, {"neval": torch.tensor(8.0)})) \
        == 0.0
    t.state = t.init_state([torch.zeros(3)])
    t.param_tree = {"w": 0}
    path = str(tmp_path / "sgd")
    t.save(path)
    back = TO.OptimMethod.load(path)
    assert isinstance(back.learningrate_schedule, TO.Poly)
    assert (back.learningrate_schedule.power,
            back.learningrate_schedule.max_iteration) == (0.5, 10)
    assert float(back.current_rate({"neval": torch.tensor(5.0)})) == \
        pytest.approx(float(t.current_rate({"neval": torch.tensor(5.0)})))


def test_inception_cli_trains_from_a_folder(tmp_path):
    root = write_folder(tmp_path / "data", classes=2, per_class=2, val=1,
                        sizes=((230, 250), (240, 236)))
    ck = str(tmp_path / "ck")
    opt = TI.main(["-f", root, "--version", "v1", "-b", "2", "-e", "1",
                   "--checkpoint", ck, "--device", "cpu"])
    assert isinstance(opt, TD.DistriOptimizer)
    assert opt.state["neval"] == 3 and opt.state["score"] is not None
    assert isinstance(opt.optim_method.learningrate_schedule, TO.Poly)
    (prefix,) = TS.checkpoint_prefixes(ck)
    assert TS.verify_checkpoint(os.path.join(ck, prefix))[0]
    cpu = TI.build_inception_v1(2, device="cpu")
    TS.load_checkpoint(os.path.join(ck, prefix), cpu)
    for a, b in zip(T.leaves(cpu.params()), T.leaves(opt.model.params())):
        assert torch.equal(a, b.detach())


def test_inception_cli_synthetic_v2():
    opt = TI.main(["--version", "v2", "-n", "2", "-b", "2", "-e", "1",
                   "--device", "cpu"])
    assert opt.state["neval"] == 2 and np.isfinite(opt.state["loss"])


def test_inception_cli_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["-n", "2", "-b", "2"], ["-f", "unused", "-b", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TI.main(argv)
        assert not Engine.is_initialized()
    for build in (TI.build_inception_v1, TI.build_inception_v2,
                  TV.build_vgg16, TV.build_vgg19, TV.build_vgg_cifar):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
