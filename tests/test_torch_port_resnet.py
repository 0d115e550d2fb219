"""The port's ResNet path against the JAX package, on the CPU.

Each ported layer, the fused conv + BN module, ``fuse_conv_bn`` and the
seeded ResNet builders are run in both packages on the same numpy
inputs and weights (carried with ``utils/convert``), and the whole
ResNet-50 (64x64, batch 2, 10 classes, unfused and fused) is compared
in its loss, input gradient, parameter gradients and new BN state
against ``jax.value_and_grad`` of ``model.apply``; the JAX fused model
runs its Pallas kernels in interpret mode.

Limits (f32 on both sides, sums in other orders): layer outputs and
states atol 2e-5, rtol 1e-5; whole-model loss atol 1e-5, input
gradient atol 2e-5, each parameter's gradient within 2e-4 of its
largest |value| (7x the 2.8e-5 seen), new BN state atol 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.nn import fused as JF
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.nn import fused as TF
from bigdl_tpu_torch.ops.conv_bn import kernel_path
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

ATOL, RTOL = 2e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _close_trees(got, want, atol=ATOL, rtol=RTOL):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _randomize(jm, seed):
    """Random params and running stats on a JAX module, so that BN sees
    a non-trivial shift and affine."""
    rs = np.random.RandomState(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        rs.randn(*a.shape).astype(np.float32) * 0.5), jm.params())
    jm.set_params(p)
    st = jax.tree.map(lambda a: jnp.asarray(
        rs.rand(*a.shape).astype(np.float32) + 0.5), jm.state())
    jm.set_state(st)


def _both(jm, tm, x, training):
    """(JAX output, JAX new state, port output, port new state)."""
    load_jax_params(tm, _np(jm.params()))
    load_jax_state(tm, _np(jm.state()))
    jy, jst = jm.apply(jm.params(), jm.state(), jnp.asarray(x),
                       training=training)
    tm.train(training)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    return np.asarray(jy), _np(jst), ty.numpy(), tm.state()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("spatial", [True, False])
def test_batchnorm_forward_and_running_stats(training, spatial):
    if spatial:
        jm = JN.SpatialBatchNormalization(5)
        tm = TN.SpatialBatchNormalization(5)
        x = _x(4, 5, 6, 7, seed=1) * 3.0 + 2.0
    else:
        jm, tm = JN.BatchNormalization(5), TN.BatchNormalization(5)
        x = _x(8, 5, seed=2) * 3.0 + 2.0
    _randomize(jm, seed=7)
    jy, jst, ty, tst = _both(jm, tm, x, training)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=RTOL)
    _close_trees(tst, jst)


def test_batchnorm_gradient_flows_through_the_statistics():
    jm, tm = JN.SpatialBatchNormalization(3), TN.SpatialBatchNormalization(3)
    _randomize(jm, seed=3)
    load_jax_params(tm, _np(jm.params()))
    load_jax_state(tm, _np(jm.state()))
    x = _x(2, 3, 4, 4, seed=5)
    g = _x(2, 3, 4, 4, seed=6)

    def f(p, xx):
        return jnp.sum(jm.apply(p, jm.state(), xx, training=True)[0] * g)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(jm.params(), jnp.asarray(x))
    tm.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    (tm(tx) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=1e-4)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(jgp["weight"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(jgp["bias"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("make", [
    lambda M: M.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
    lambda M: M.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True),
    lambda M: M.SpatialMaxPooling(2, 2),
    lambda M: M.SpatialAveragePooling(3, 3, 2, 2, 1, 1),
    lambda M: M.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                      count_include_pad=False),
    lambda M: M.SpatialAveragePooling(3, 3, 2, 2, ceil_mode=True),
    lambda M: M.SpatialAveragePooling(2, 2, 2, 2, divide=False),
    lambda M: M.SpatialAveragePooling(7, 7, 1, 1, global_pooling=True),
], ids=["max_pad", "max_ceil", "max_2x2", "avg_pad", "avg_no_pad_count",
        "avg_ceil", "avg_sum", "avg_global"])
def test_pooling(make):
    x = _x(2, 3, 9, 11, seed=4)
    jy, _, ty, _ = _both(make(JN), make(TN), x, training=False)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("make,shape", [
    (lambda M: M.Reshape([12]), (2, 3, 4)),
    (lambda M: M.Reshape([3, 4]), (12,)),
    (lambda M: M.Reshape([12]), (1, 3, 4)),
    (lambda M: M.Reshape([6, 2], batch_mode=True), (2, 3, 4)),
    (lambda M: M.View(-1, 6), (2, 3, 4)),
    (lambda M: M.View(12), (2, 3, 4)),
    (lambda M: M.View([4, 6]), (2, 3, 4)),
    (lambda M: M.LogSoftMax(), (3, 7)),
    (lambda M: M.ReLU(), (3, 7)),
    (lambda M: M.Identity(), (3, 7)),
], ids=["reshape_batched", "reshape_flat", "reshape_batch1",
        "reshape_batch_mode", "view_wildcard", "view_batched", "view_list",
        "logsoftmax", "relu", "identity"])
def test_shape_and_elementwise_layers(make, shape):
    x = _x(*shape, seed=8)
    jy, _, ty, _ = _both(make(JN), make(TN), x, training=False)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=RTOL)


def test_relu_splits_the_gradient_at_zero_like_jax():
    x = np.array([-1.0, 0.0, 2.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(JN.ReLU().apply({}, {}, a)[0]))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    TN.ReLU()(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


def _residual(M):
    main = M.Sequential().add(M.SpatialConvolution(4, 4, 3, 3, 1, 1, 1, 1)) \
        .add(M.SpatialBatchNormalization(4))
    return M.Sequential().add(M.ConcatTable().add(main).add(M.Identity())) \
        .add(M.CAddTable()).add(M.ReLU())


@pytest.mark.parametrize("training", [True, False])
def test_concat_table_and_cadd_table(training):
    JRandom.RNG.set_seed(11)
    jm = _residual(JN)
    TRandom.RNG.set_seed(11)
    tm = _residual(TN)
    _close_trees(tm.params(), _np(jm.params()), atol=0, rtol=0)
    jy, jst, ty, tst = _both(jm, tm, _x(2, 4, 5, 5, seed=9), training)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=RTOL)
    _close_trees(tst, jst)
    out = tm.child("0")(torch.zeros(1, 4, 5, 5))
    assert isinstance(out, tuple) and len(out) == 2


@pytest.mark.parametrize("make", [
    lambda M: M.ClassNLLCriterion(),
    lambda M: M.ClassNLLCriterion(weights=[0.5, 1.0, 2.0, 1.5],
                                  size_average=False),
    lambda M: M.ClassNLLCriterion(weights=[0.5, 1.0, 2.0, 1.5]),
    lambda M: M.ClassNLLCriterion(padding_value=3),
    lambda M: M.CrossEntropyCriterion(),
    lambda M: M.CrossEntropyCriterion(weights=[1.0, 0.2, 3.0, 1.0]),
], ids=["nll", "nll_weights_sum", "nll_weights_mean", "nll_padding", "ce",
        "ce_weights"])
def test_criterions(make):
    rs = np.random.RandomState(12)
    logits = rs.randn(6, 4).astype(np.float32)
    inp = np.array(jax.nn.log_softmax(logits)) \
        if "NLL" in type(make(JN)).__name__ else logits
    tgt = np.array([1, 2, 3, 4, 3, 1], np.float32)       # 1-based
    jl, jg = jax.value_and_grad(lambda a: make(JN).loss(a, jnp.asarray(tgt)))(
        jnp.asarray(inp))
    ti = torch.from_numpy(inp).requires_grad_(True)
    tl = make(TN).loss(ti, torch.from_numpy(tgt))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-5)


# ----------------------------------------------------------- fused module


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("kernel,stride,relu", [(1, 1, True), (1, 2, False),
                                                (3, 1, False), (3, 2, True)])
def test_fused_module_train_eval_and_state(kernel, stride, relu, training):
    JRandom.RNG.set_seed(kernel + stride)
    jm = JF.SpatialConvolutionBatchNorm(6, 10, stride=stride, kernel=kernel,
                                        with_relu=relu)
    TRandom.RNG.set_seed(kernel + stride)
    tm = TF.SpatialConvolutionBatchNorm(6, 10, stride=stride, kernel=kernel,
                                        with_relu=relu)
    _close_trees(tm.params(), _np(jm.params()), atol=0, rtol=0)
    _randomize(jm, seed=kernel * 10 + stride)
    jy, jst, ty, tst = _both(jm, tm, _x(3, 6, 9, 8, seed=13) + 1.0,
                             training)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=RTOL)
    _close_trees(tst, jst)


def _count_fused(model):
    kinds = []
    for m in model.modules():
        if isinstance(m, TF.SpatialConvolutionBatchNorm):
            kinds.append((m.kernel, m.stride))
    return kinds


def test_fuse_resnet50_gives_52_fused_sites_on_the_two_kernels():
    TRandom.RNG.set_seed(0)
    model = TF.fuse_conv_bn(TR.build_resnet_imagenet(50, 10, device="cpu"))
    kinds = _count_fused(model)
    assert len(kinds) == 52
    paths = [kernel_path((2, 64, 56, 56), (64, 64, k, k), stride=s,
                         pad=(k - 1) // 2) for k, s in kinds]
    assert paths.count("cuda_1x1") == 36 and paths.count("cuda_kxk") == 16
    assert sum(1 for k, s in kinds if k == 3 and s == 2) == 3
    assert sum(1 for k, s in kinds if k == 1 and s == 2) == 3
    # the 7x7 stem stays a plain conv
    assert type(model.modules[0]) is TN.SpatialConvolution
    assert model.modules[0].kernel_w == 7


def test_fuse_shares_the_pair_tensors():
    TRandom.RNG.set_seed(1)
    seq = TN.Sequential().add(TN.SpatialConvolution(4, 8, 1, 1,
                                                    with_bias=False)) \
        .add(TN.SpatialBatchNormalization(8)).add(TN.ReLU())
    conv, bn = seq.modules[0], seq.modules[1]
    TF.fuse_conv_bn(seq)
    (fused,) = seq.modules
    assert fused.with_relu and fused.bn_weight is bn.weight
    assert fused.running_mean is bn.running_mean
    assert fused.weight.data_ptr() == conv.weight.data_ptr()
    assert tuple(fused.weight.shape) == (8, 4)


def test_seeded_resnet_builders_draw_the_jax_numbers():
    for build_j, build_t, args in (
            (JR.build_resnet_imagenet, TR.build_resnet_imagenet, (50, 10)),
            (JR.build_resnet_cifar, TR.build_resnet_cifar, (20, 10))):
        JRandom.RNG.set_seed(5)
        jm = build_j(*args)
        TRandom.RNG.set_seed(5)
        tm = build_t(*args, device="cpu")
        _close_trees(tm.params(), _np(jm.params()), atol=0, rtol=0)
        _close_trees(tm.state(), _np(jm.state()), atol=0, rtol=0)
        JF.fuse_conv_bn(jm)
        TF.fuse_conv_bn(tm)
        _close_trees(tm.params(), _np(jm.params()), atol=0, rtol=0)
        # fusing drew the same numbers in both packages
        assert JRandom.RNG.uniform(0, 1) == TRandom.RNG.uniform(0, 1)


# ------------------------------------------------------- whole ResNet-50


@pytest.fixture(scope="module", params=["unfused", "fused"])
def resnet50_pair(request):
    """JAX and port ResNet-50 (10 classes, LogSoftMax dropped for
    CrossEntropy) from one seed, and the JAX loss, gradients and new
    state on one 64x64 batch of 2."""
    fused = request.param == "fused"
    JRandom.RNG.set_seed(3)
    jm = JR.build_resnet_imagenet(50, 10)
    TRandom.RNG.set_seed(3)
    tm = TR.build_resnet_imagenet(50, 10, device="cpu")
    if fused:
        JF.fuse_conv_bn(jm)
        TF.fuse_conv_bn(tm)
    jm.modules = jm.modules[:-1]
    tm.modules = tm.modules[:-1]
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, 10, 2) + 1).astype(np.float32)
    crit = JN.CrossEntropyCriterion()
    state = jm.state()

    def loss_fn(p, xx):
        out, st = jm.apply(p, state, xx, training=True)
        return crit.loss(out, jnp.asarray(y)), st

    (loss, new_state), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jm.params(), jnp.asarray(x))
    return dict(tm=tm, x=x, y=y, loss=float(loss), gx=np.asarray(gx),
                gp=_flat(_np(gp)), state=_np(new_state), params=jm.params())


def test_resnet50_loss_and_gradients_match_jax(resnet50_pair):
    r = resnet50_pair
    tm = r["tm"]
    load_jax_params(tm, _np(r["params"]))      # same weights, exactly
    tm.train()
    tx = torch.from_numpy(r["x"]).requires_grad_(True)
    named = list(tm.named_parameters())
    loss = TN.CrossEntropyCriterion().loss(tm(tx), torch.from_numpy(r["y"]))
    grads = torch.autograd.grad(loss, [tx] + [p for _, p in named])
    np.testing.assert_allclose(loss.item(), r["loss"], atol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), r["gx"], atol=2e-5)
    assert set(n for n, _ in named) == set(r["gp"])
    for (name, _), g in zip(named, grads[1:]):
        want = r["gp"][name]
        err = np.abs(g.numpy() - want).max()
        assert err <= 2e-4 * max(np.abs(want).max(), 1e-3), (name, err)
    _close_trees(tm.state(), r["state"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_bottlenecks_with_live_main_branch_gradients_match_jax(fused):
    """The builder's zero gamma of each block's last BN gives every main
    branch of the whole-ResNet-50 test above a zero cotangent, so there
    the 3x3 sites' backward (and the gs1/gs2 it carries) is compared as
    0 with 0.  Two bottlenecks with gamma = 1 (a strided one, 5x5 from
    10x10, then a stride-1 one) send a cotangent through every site.  A
    ResNet-50 with live main branches is no test in f32: one ulp on its
    input moves some of its parameters' gradients by over 20%.  Limits
    as the whole-model test, but the loss (a sum of 1600 products, near
    48) within the layers' rtol of 1e-5."""
    def build(M):
        return M.Sequential().add(
            (JR if M is JN else TR).bottleneck(16, 8, 2, False)).add(
            (JR if M is JN else TR).bottleneck(32, 8, 1, False))
    JRandom.RNG.set_seed(6)
    jm = build(JN)
    TRandom.RNG.set_seed(6)
    tm = build(TN)
    if fused:
        JF.fuse_conv_bn(jm)
        TF.fuse_conv_bn(tm)
        assert sorted(_count_fused(tm)) == [(1, 1)] * 4 + [(1, 2)] + \
            [(3, 1), (3, 2)]
    load_jax_params(tm, _np(jm.params()))
    load_jax_state(tm, _np(jm.state()))
    x = _x(2, 16, 10, 10, seed=8)
    r = _x(2, 32, 5, 5, seed=9)

    def loss_fn(p, xx):
        out, st = jm.apply(p, jm.state(), xx, training=True)
        return jnp.sum(out * jnp.asarray(r)), st

    (loss, new_state), (gp, gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jm.params(), jnp.asarray(x))
    tm.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    named = list(tm.named_parameters())
    tloss = (tm(tx) * torch.from_numpy(r)).sum()
    grads = torch.autograd.grad(tloss, [tx] + [p for _, p in named])
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=RTOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), atol=2e-5)
    gp = _flat(_np(gp))
    assert set(n for n, _ in named) == set(gp)
    for (name, _), g in zip(named, grads[1:]):
        want = gp[name]
        assert np.abs(want).max() > 0, name      # every site gets a cotangent
        err = np.abs(g.numpy() - want).max()
        assert err <= 2e-4 * max(np.abs(want).max(), 1e-3), (name, err)
    _close_trees(tm.state(), _np(new_state), atol=2e-5, rtol=0)


def test_container_modules_is_a_list_and_torch_modules_still_works():
    seq = TN.Sequential().add(TN.ReLU()).add(TN.Identity()).add(
        TN.LogSoftMax())
    assert [type(m).__name__ for m in seq.modules] == [
        "ReLU", "Identity", "LogSoftMax"]
    seq.modules = seq.modules[:-1]
    assert list(seq._modules) == ["0", "1"]
    assert len(list(seq.modules())) == 3       # torch's walk, self included
    seq.add(TN.Linear(2, 3))
    assert set(seq.params()) == {"0", "1", "2"}
    assert set(seq.params()["2"]) == {"weight", "bias"}


def test_load_jax_state_rejects_an_incomplete_tree():
    JRandom.RNG.set_seed(2)
    jm = _residual(JN)
    TRandom.RNG.set_seed(2)
    tm = _residual(TN)
    tree = _np(jm.state())
    del tree["0"]["0"]["1"]["running_var"]
    with pytest.raises(KeyError, match="0/0/1/running_var"):
        load_jax_state(tm, tree)
