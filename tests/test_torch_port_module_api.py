"""The port's stateful module API against the JAX package, on the CPU.

The classic BigDL loop (``update_output`` -> criterion ``forward``/
``backward`` -> ``zero_grad_parameters`` -> ``backward`` ->
``update_parameters``) runs 3 steps in both packages on a small
conv + BN + Linear ``Sequential`` and on a 2-layer ``TransformerLM``
(dim 32) from the same weights and inputs: each step's loss, input
gradient and the BN running statistics within 1e-5 of the largest |JAX
value|, the ``grad_params`` tree and the weights after
``update_parameters`` within 1e-5 of the step's largest |JAX gradient|
and |JAX weight| (2e-5 for the LM's weights, the limit of
``test_torch_port_lm_train.py``: f32 sums of the same products in other
orders).  Then the contracts the JAX docstrings state, in both
packages; table and integer inputs; ``get_weights`` order and
``set_weights`` across the packages for each shared ``build_*`` model; npz
weight files read both ways; every ``reset()`` override drawing JAX's
numbers from the same seed; and ``criterion.backward`` against JAX's
over the criterion parity cases."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.nn import criterion as JC
from bigdl_tpu.nn import module as JM
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.nn import criterion as TC
from bigdl_tpu_torch.nn import module as TM

from test_torch_port_criterion import CASES as CRITERION_CASES
from torch_port_parity import carry, rel, tleaves, to_np

TOL = 1e-5
LM_WEIGHT_TOL = 2e-5

# public names of the JAX classes the port leaves out, with the reason
LEFT_OUT = {
    "training": "torch owns the attribute: its mode flag; ``train()`` "
                "switches the mode",
    "apply": "no pure functional core: torch's ``Module.apply(fn)`` keeps "
             "the name",
    "update_output_pure": "no pure functional core: ``forward`` is the "
                          "computation",
    "parameters": "torch's iterator keeps the name; the BigDL (weights, "
                  "gradients) pair is ``parameters_and_grads()``",
}


@pytest.mark.parametrize("pair", [
    (JM.AbstractModule, TM.AbstractModule),
    (JM.Container, TM.Container),
    (JC.AbstractCriterion, TC.AbstractCriterion),
], ids=["AbstractModule", "Container", "AbstractCriterion"])
def test_every_public_method_is_ported_or_left_out(pair):
    jcls, tcls = pair
    names = [n for n in dir(jcls) if not n.startswith("_")]
    missing = [n for n in names if n not in LEFT_OUT and not hasattr(tcls, n)]
    assert not missing, missing
    assert len(names) > 4


def test_parameters_and_grads_is_the_bigdl_parameters_form():
    JRandom.RNG.set_seed(0)
    jm = _j_conv_model()
    tm = _t_conv_model()
    carry(jm, tm)
    jw, jg = jm.parameters()
    tw, tg = tm.parameters_and_grads()
    assert len(jw) == len(tw) == len(tg) == len(jg)
    for a, b in zip(tw, jw):
        assert np.array_equal(to_np(a), np.asarray(b))
    assert all(not to_np(g).any() for g in tg)


# ---------------------------------------------------------------- the loop
def _j_conv_model():
    return JN.Sequential().add(JN.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(JN.SpatialBatchNormalization(4)).add(JN.ReLU()) \
        .add(JN.View(4 * 6 * 6)).add(JN.Linear(4 * 6 * 6, 5))


def _t_conv_model():
    return TN.Sequential().add(TN.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)) \
        .add(TN.SpatialBatchNormalization(4)).add(TN.ReLU()) \
        .add(TN.View(4 * 6 * 6)).add(TN.Linear(4 * 6 * 6, 5))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            # a copy: the port's trees hold the live tensors
            out[f"{prefix}{k}"] = np.array(to_np(v))
    return out


def _classic_steps(m, crit, batches, lr):
    """The classic loop; per step (loss, grad_input, grad_params,
    params after the update, state after the step), all on the host."""
    out = []
    for x, y in batches:
        o = m.update_output(x)
        loss = crit.forward(o, y)
        g = crit.backward(o, y)
        m.zero_grad_parameters()
        gi = m.backward(x, g)
        grads = _flat(m.grad_params())
        m.update_parameters(lr)
        out.append((float(to_np(loss)), gi, grads, _flat(m.params()),
                    _flat(m.state())))
    return out


def _compare_steps(t_steps, j_steps, weight_tol):
    for step, (t, j) in enumerate(zip(t_steps, j_steps)):
        assert abs(t[0] - j[0]) <= TOL * max(1.0, abs(j[0])), (step, t[0], j[0])
        if t[1] is None:        # integer input: JAX gives float0
            assert np.asarray(j[1]).dtype == jax.dtypes.float0
        else:
            assert rel(t[1], j[1]) <= TOL, ("grad_input", step)
        assert t[2].keys() == j[2].keys()
        # a gradient that is 0 in exact arithmetic (a conv bias before a
        # BN, an attention key bias) is rounding noise on both sides:
        # each gradient is held to the step's largest |JAX gradient|
        scale = max(float(np.max(np.abs(v))) for v in j[2].values())
        for k in j[2]:
            err = float(np.max(np.abs(t[2][k] - j[2][k])))
            assert err <= TOL * max(scale, 1e-30), ("grad", step, k, err)
        # the same for the weights: such a bias starts at 0 and moves by
        # that noise alone
        wscale = max(float(np.max(np.abs(v))) for v in j[3].values())
        for k in j[3]:
            err = float(np.max(np.abs(t[3][k] - j[3][k])))
            assert err <= weight_tol * wscale, ("weight", step, k, err)
        assert t[4].keys() == j[4].keys()
        for k in j[4]:
            assert rel(t[4][k], j[4][k]) <= TOL, ("state", step, k)


def test_classic_loop_conv_bn_linear_matches_jax():
    JRandom.RNG.set_seed(0)
    jm = _j_conv_model()
    tm = _t_conv_model()
    carry(jm, tm)
    rs = np.random.RandomState(0)
    batches = [(rs.randn(4, 3, 6, 6).astype(np.float32),
                (rs.randint(0, 5, 4) + 1).astype(np.float32))
               for _ in range(3)]
    j_steps = _classic_steps(jm, JN.CrossEntropyCriterion(), batches, 0.1)
    t_steps = _classic_steps(tm, TN.CrossEntropyCriterion(), batches, 0.1)
    _compare_steps(t_steps, j_steps, TOL)
    # the BN running statistics moved once a step: 3 EMA updates
    assert not np.allclose(t_steps[-1][4]["1.running_mean"], 0.0)
    assert rel(t_steps[-1][4]["1.running_mean"],
               j_steps[-1][4]["1.running_mean"]) <= TOL


def test_classic_loop_transformer_lm_matches_jax():
    from bigdl_tpu.models.transformer import build_transformer_lm as j_build
    from bigdl_tpu_torch.models.transformer import \
        build_transformer_lm as t_build

    tiny = dict(dim=32, n_head=2, n_layer=2, max_len=16)
    JRandom.RNG.set_seed(3)
    jm = j_build(64, attn_impl="pallas_interpret", **tiny)
    TRandom.RNG.set_seed(3)
    tm = t_build(64, attn_impl="kernel", device="cpu", **tiny)
    rs = np.random.RandomState(0)
    batches = [(rs.randint(0, 64, (4, 16)).astype(np.int32),
                (rs.randint(0, 64, (4, 16)) + 1).astype(np.int32))
               for _ in range(3)]
    j_steps = _classic_steps(jm, JN.CrossEntropyCriterion(), batches, 0.1)
    t_steps = _classic_steps(tm, TN.CrossEntropyCriterion(), batches, 0.1)
    _compare_steps(t_steps, j_steps, LM_WEIGHT_TOL)


# ------------------------------------------------------------ the contracts
def _pkg(name):
    return (JN, JRandom) if name == "jax" else (TN, TRandom)


def _linear_case(name):
    N, R = _pkg(name)
    R.RNG.set_seed(4)
    m = N.Linear(3, 2)
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    g = np.random.RandomState(2).randn(5, 2).astype(np.float32)
    m.update_output(x)
    return m, x, g


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_update_grad_input_accumulates_nothing(pkg):
    m, x, g = _linear_case(pkg)
    m.zero_grad_parameters()
    gi = m.update_grad_input(x, g)
    assert all(not to_np(v).any() for v in _flat(m.grad_params()).values())
    assert rel(gi, g @ to_np(m.weight)) <= TOL
    assert gi is m.grad_input


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_two_acc_grad_parameters_give_twice_one(pkg):
    m, x, g = _linear_case(pkg)
    m.zero_grad_parameters()
    m.acc_grad_parameters(x, g)
    once = _flat(m.grad_params())
    m.acc_grad_parameters(x, g)
    twice = _flat(m.grad_params())
    assert rel(once["weight"], g.T @ x) <= TOL
    for k in once:
        assert rel(twice[k], 2 * once[k]) <= TOL
    m.zero_grad_parameters()
    assert all(not v.any() for v in _flat(m.grad_params()).values())


def test_backward_equals_update_grad_input_plus_acc_grad_parameters():
    m, x, g = _linear_case("port")
    m.zero_grad_parameters()
    gi = m.backward(x, g)
    both = _flat(m.grad_params())
    m.zero_grad_parameters()
    m.acc_grad_parameters(x, g)
    assert rel(m.update_grad_input(x, g), gi) == 0.0
    for k, v in _flat(m.grad_params()).items():
        assert rel(v, both[k]) == 0.0


def test_update_parameters_is_sgd_in_place():
    m, x, g = _linear_case("port")
    w = m.weight
    before = to_np(w).copy()
    m.zero_grad_parameters()
    m.backward(x, g)
    m.update_parameters(0.5)
    assert m.weight is w
    np.testing.assert_array_equal(
        to_np(w), before - np.float32(0.5) * to_np(w.grad))


def test_backward_on_another_input_recomputes_with_state_kept():
    """A backward on an input other than the last update_output's runs
    the forward again with the BN buffers saved and restored: the
    statistics move once, and the gradients are the kept graph's."""
    TRandom.RNG.set_seed(0)
    m = _t_conv_model()
    x = np.random.RandomState(0).randn(4, 3, 6, 6).astype(np.float32)
    g = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    m.update_output(x)
    stats = {k: v.copy() for k, v in _flat(m.state()).items()}
    m.zero_grad_parameters()
    kept = m.backward(x, g)
    kept_g = _flat(m.grad_params())
    m.zero_grad_parameters()
    again = m.backward(x.copy(), g)           # another object: recompute
    for k, v in _flat(m.state()).items():
        np.testing.assert_array_equal(v, stats[k])
    assert rel(again, kept) <= TOL
    scale = max(float(np.max(np.abs(v))) for v in kept_g.values())
    for k, v in _flat(m.grad_params()).items():
        assert float(np.max(np.abs(v - kept_g[k]))) <= TOL * scale, k


def test_dropout_backward_uses_the_forward_mask():
    TRandom.RNG.set_seed(0)
    m = TN.Sequential().add(TN.Linear(8, 8)).add(TN.Dropout(0.5))
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    out = m.update_output(x)
    gi_kept = m.update_grad_input(x, torch.ones_like(out))
    gi_again = m.update_grad_input(x.copy(), torch.ones_like(out))
    assert (out == 0).any() and (out != 0).any()
    assert rel(gi_again, gi_kept) <= TOL
    # a second update_output draws another mask
    out2 = m.update_output(x)
    assert not torch.equal(out2 == 0, out == 0)


# -------------------------------------------------------- table and integer
def test_table_input_gives_a_table_of_gradients():
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    g = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    jm, tm = JN.CMulTable(), TN.CMulTable()
    jm.forward((jnp.asarray(a), jnp.asarray(b)))
    jg = jm.backward((jnp.asarray(a), jnp.asarray(b)), jnp.asarray(g))
    tm.update_output((a, b))
    tg = tm.backward((a, b), g)
    assert isinstance(tg, tuple) and isinstance(jg, tuple)
    for u, v in zip(tg, jg):
        assert rel(u, v) <= TOL


def test_integer_input_gradient_is_none_where_jax_gives_float0():
    """Pinned both ways: JAX's gradient of token ids is a ``float0``
    array, the port's is ``None``; the embedding's own gradient agrees."""
    JRandom.RNG.set_seed(2)
    jm = JN.LookupTable(10, 4)
    tm = TN.LookupTable(10, 4)
    carry(jm, tm)
    ids = np.array([[1, 3, 3], [10, 2, 1]], np.int32)
    g = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    jm.forward(jnp.asarray(ids))
    jm.zero_grad_parameters()
    jg = jm.backward(jnp.asarray(ids), jnp.asarray(g))
    assert np.asarray(jg).dtype == jax.dtypes.float0
    tm.update_output(ids)
    tm.zero_grad_parameters()
    assert tm.backward(ids, g) is None
    assert rel(tm.grad_params()["weight"],
               jm.grad_params()["weight"]) <= TOL
    # a table with an integer entry keeps its place with None
    tm2 = TN.SelectTable(1)
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    tm2.update_output((x, ids))
    gx = tm2.backward((x, ids), np.ones((2, 3), np.float32))
    assert gx[1] is None and rel(gx[0], np.ones((2, 3))) == 0.0


# --------------------------------------------------------- weights I/O
def _models():
    from bigdl_tpu.models import autoencoder as ja, inception as ji, \
        lenet as jl, ncf as jn, resnet as jr, rnn as jrn, transformer as jt, \
        vgg as jv
    from bigdl_tpu_torch.models import autoencoder as ta, inception as ti, \
        lenet as tl, ncf as tn, resnet as tr, rnn as trn, \
        transformer as tt, vgg as tv

    lm = dict(dim=32, n_head=2, n_layer=2, max_len=16)
    return {
        "lenet5": (lambda: jl.build_lenet5(10),
                   lambda: tl.build_lenet5(10, device="cpu"),
                   lambda: np.random.RandomState(0).randn(2, 28, 28)),
        "resnet_cifar20": (lambda: jr.build_resnet_cifar(20, 10),
                           lambda: tr.build_resnet_cifar(20, 10, device="cpu"),
                           lambda: np.random.RandomState(0).randn(
                               2, 3, 32, 32)),
        "vgg_cifar": (lambda: jv.build_vgg_cifar(10),
                      lambda: tv.build_vgg_cifar(10, device="cpu"),
                      lambda: np.random.RandomState(0).randn(2, 3, 32, 32)),
        "ptb_lm": (lambda: jrn.build_ptb_lm(50, 8, 16, 2),
                   lambda: trn.build_ptb_lm(50, 8, 16, 2, device="cpu"),
                   lambda: np.random.RandomState(0).randint(1, 51, (2, 5))),
        "autoencoder": (lambda: ja.build_autoencoder(32),
                        lambda: ta.build_autoencoder(32, device="cpu"),
                        lambda: np.random.RandomState(0).rand(2, 28, 28)),
        "ncf_graph": (lambda: jn.build_ncf(30, 40),
                      lambda: tn.build_ncf(30, 40, device="cpu"),
                      lambda: np.stack([
                          np.random.RandomState(0).randint(1, 31, 4),
                          np.random.RandomState(1).randint(1, 41, 4)],
                          1).astype(np.float32)),
        "inception_v1": (lambda: ji.build_inception_v1(1000, False),
                         lambda: ti.build_inception_v1(1000, False,
                                                       device="cpu"),
                         lambda: np.random.RandomState(0).randn(
                             1, 3, 224, 224)),
        "transformer_lm": (lambda: jt.build_transformer_lm(
            64, attn_impl="reference", **lm), lambda: tt.build_transformer_lm(
            64, attn_impl="reference", device="cpu", **lm),
            lambda: np.random.RandomState(0).randint(0, 64, (2, 16))),
    }


def _jax_out(jm, x):
    jm.evaluate()
    return np.asarray(jm.apply(jm.params(), jm.state(), jnp.asarray(x))[0])


def _port_out(tm, x):
    tm.evaluate()
    with torch.no_grad():
        return to_np(tm(torch.as_tensor(x)))


def _input(x):
    return x.astype(np.int32) if x.dtype.kind == "i" else x.astype(np.float32)


@pytest.mark.parametrize("name", list(_models()))
def test_get_weights_order_and_set_weights_across_packages(name):
    jb, tb, make_x = _models()[name]
    JRandom.RNG.set_seed(7)
    jm = jb()
    TRandom.RNG.set_seed(11)                  # other numbers on purpose
    tm = tb()
    jw, tw = jm.get_weights(), tm.get_weights()
    assert [w.shape for w in tw] == [np.shape(w) for w in jw]
    tm.set_weights(jw)
    for a, b in zip(tm.get_weights(), jw):
        np.testing.assert_array_equal(a, np.asarray(b))
    # JAX's running statistics too, then the outputs agree
    from bigdl_tpu_torch.utils.convert import load_jax_state

    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))
    x = _input(make_x())
    assert rel(_port_out(tm, x), _jax_out(jm, x)) <= 1e-4


def test_flagship_get_weights_matches_jax_count_and_shapes():
    """The flagship of ``chip_smoke.py`` (vocab 8192, dim 512, 8 heads,
    8 layers, max_len 512): 133 tensors in both packages, shapes in
    order (``chip_smoke.py`` phase 29 (c) holds the weights' file on the
    card)."""
    from bigdl_tpu.models.transformer import build_transformer_lm as j_build
    from bigdl_tpu_torch.models.transformer import \
        build_transformer_lm as t_build

    cfg = dict(dim=512, n_head=8, n_layer=8, max_len=512)
    JRandom.RNG.set_seed(0)
    j_shapes = [np.shape(w) for w in j_build(8192, **cfg).get_weights()]
    TRandom.RNG.set_seed(0)
    t_shapes = [w.shape for w in t_build(8192, device="cpu",
                                         **cfg).get_weights()]
    assert t_shapes == j_shapes
    # wte, wpe; 16 a block (ln1 2, attention 8, ln2 2, fc1 2, fc2 2);
    # ln_f 2; the head's weight
    assert len(t_shapes) == 2 + 8 * 16 + 2 + 1 == 133
    assert t_shapes[0] == (8192, 512) and t_shapes[-1] == (8192, 512)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_weights_load_across_packages(direction, tmp_path):
    JRandom.RNG.set_seed(5)
    jm = _j_conv_model()
    TRandom.RNG.set_seed(6)
    tm = _t_conv_model()
    path = str(tmp_path / "w")
    if direction == "jax_to_port":
        written = jm.save_weights(path)
        tm.load_weights(written)
        want = jm.get_weights()
    else:
        written = tm.save_weights(path)
        jm.load_weights(written)
        want = tm.get_weights()
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(want) == 6
    with pytest.raises(FileExistsError):
        tm.save_weights(path)
    tm.save_weights(path, over_write=True)


def test_save_refuses_an_existing_file_without_over_write(tmp_path):
    TRandom.RNG.set_seed(0)
    tm = _t_conv_model()
    path = str(tmp_path / "m.bigdl")
    tm.save(path)
    with pytest.raises(FileExistsError):
        tm.saveModule(path)
    tm.save(path, over_write=True)
    from bigdl_tpu_torch.utils.serializer import load_module

    back = load_module(path)
    for a, b in zip(back.get_weights(), tm.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_predict_evaluate_test_and_quantize_go_through_the_port():
    from bigdl_tpu_torch.optim import Top1Accuracy

    TRandom.RNG.set_seed(0)
    tm = TN.Sequential().add(TN.Linear(4, 3)).add(TN.LogSoftMax())
    x = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, 3, 10) + 1).astype(np.float32)
    out = tm.predict(x, batch_size=4, device="cpu")
    assert out.shape == (10, 3)
    cls = tm.predictClass(x, device="cpu")
    np.testing.assert_array_equal(cls, np.argmax(out, -1) + 1)
    (res,) = tm.evaluate((x, y), [Top1Accuracy()], 4, device="cpu")
    (res2,) = tm.test((x, y), [Top1Accuracy()], 4, device="cpu")
    assert res.result() == res2.result()
    assert abs(res.result()[0] - float(np.mean(cls == y))) <= 1e-6
    assert tm.evaluate() is tm and not tm.training
    q = tm.quantize()
    assert type(q.modules[0]).__name__ == "QuantizedLinear"
    assert type(tm.modules[0]).__name__ == "Linear"


def test_names_table_inputs_and_grad_mask():
    TRandom.RNG.set_seed(0)
    a = TN.Linear(2, 3).setName("a")
    b = TN.Linear(3, 1).set_name("b")
    m = TN.Sequential().add(a).add(b)
    table = m.getParametersTable()
    assert list(table) == ["a", "b"] and set(table["a"]) == {"weight",
                                                            "bias"}
    m.freeze("b")
    assert m.grad_mask() == {"0": {"weight": 1.0, "bias": 1.0},
                             "1": {"weight": 0.0, "bias": 0.0}}
    inp = TN.Input()
    node = a.inputs(inp)
    assert node.module is a
    g = TN.Model(inp, b.inputs(node))
    assert g(torch.ones(1, 2)).shape == (1, 1)


# ------------------------------------------------------------------ reset
def _reset_cases():
    def conn(N):
        return N.SpatialConvolutionMap(
            N.SpatialConvolutionMap.full(2, 3), 3, 3)

    return {
        "Linear": lambda N: N.Linear(3, 4),
        "SpatialConvolution": lambda N: N.SpatialConvolution(2, 4, 3, 3),
        "SpatialFullConvolution": lambda N: N.SpatialFullConvolution(
            2, 4, 3, 3),
        "TemporalConvolution": lambda N: N.TemporalConvolution(3, 4, 2),
        "LocallyConnected1D": lambda N: N.LocallyConnected1D(6, 3, 4, 2),
        "LocallyConnected2D": lambda N: N.LocallyConnected2D(
            2, 5, 5, 3, 2, 2),
        "SpatialSeparableConvolution": lambda N:
            N.SpatialSeparableConvolution(2, 4, 2, 3, 3),
        "SpatialConvolutionMap": conn,
        "Maxout": lambda N: N.Maxout(3, 4, 2),
        "Highway": lambda N: N.Highway(4),
        "SReLU": lambda N: N.SReLU((3, 4)),
        "BinaryTreeLSTM": lambda N: N.BinaryTreeLSTM(3, 4),
        "LookupTable": lambda N: N.LookupTable(10, 4, padding_value=2),
        "RnnCell": lambda N: N.RnnCell(3, 4),
        "LSTM": lambda N: N.LSTM(3, 4),
        "LSTMPeephole": lambda N: N.LSTMPeephole(3, 4),
        "GRU": lambda N: N.GRU(3, 4),
        "ConvLSTMPeephole": lambda N: N.ConvLSTMPeephole(2, 3, 3, 3),
        "LayerNorm": lambda N: N.LayerNorm(4),
        "MultiHeadAttention": lambda N: N.MultiHeadAttention(8, 2),
        "PositionalEmbedding": lambda N: N.PositionalEmbedding(5, 4),
        "VolumetricConvolution": lambda N: N.VolumetricConvolution(
            2, 3, 2, 2, 2),
        "VolumetricFullConvolution": lambda N: N.VolumetricFullConvolution(
            2, 3, 2, 2, 2),
        "Sequential": lambda N: N.Sequential().add(N.Linear(3, 4))
        .add(N.Tanh()).add(N.Linear(4, 2)),
    }


@pytest.mark.parametrize("name", list(_reset_cases()))
def test_reset_draws_jax_numbers_from_the_same_seed(name):
    build = _reset_cases()[name]
    JRandom.RNG.set_seed(9)
    jm = build(JN)
    TRandom.RNG.set_seed(9)
    tm = build(TN)
    first = [w.copy() for w in tm.get_weights()]
    before = {id(p): p for p in tm.parameters()}
    JRandom.RNG.set_seed(21)
    assert jm.reset() is jm
    TRandom.RNG.set_seed(21)
    assert tm.reset() is tm
    jw, tw = jm.get_weights(), tm.get_weights()
    assert len(tw) == len(jw) > 0
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, np.asarray(b))
    # drawn into the live tensors
    assert {id(p) for p in tm.parameters()} == set(before)
    if name not in ("LayerNorm",):
        assert any(not np.array_equal(a, b) for a, b in zip(first, tw))


def test_transformer_lm_reset_draws_jax_numbers():
    from bigdl_tpu.models.transformer import build_transformer_lm as j_build
    from bigdl_tpu_torch.models.transformer import \
        build_transformer_lm as t_build

    tiny = dict(dim=16, n_head=2, n_layer=2, max_len=8)
    JRandom.RNG.set_seed(1)
    jm = j_build(32, attn_impl="reference", **tiny)
    TRandom.RNG.set_seed(1)
    tm = t_build(32, attn_impl="reference", device="cpu", **tiny)
    JRandom.RNG.set_seed(4)
    jm.reset()
    TRandom.RNG.set_seed(4)
    tm.reset()
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))


# -------------------------------------------------------------- criterion
@pytest.mark.parametrize("case", CRITERION_CASES,
                         ids=[c[0] for c in CRITERION_CASES])
def test_criterion_backward_matches_jax(case):
    _, build, make_input, make_target = case
    inp, target = make_input(), make_target()
    jc, tc = build(JN), build(TN)

    def jtree(t):
        return tuple(jtree(u) for u in t) if isinstance(t, tuple) \
            else jnp.asarray(t)

    want_loss = jc.updateOutput(jtree(inp), jtree(target))
    want = jc.updateGradInput(jtree(inp), jtree(target))
    got_loss = tc.updateOutput(inp, target)
    got = tc.updateGradInput(inp, target)
    assert got is tc.grad_input
    assert rel(got_loss, want_loss) <= TOL
    got_l, want_l = tleaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert rel(a, b) <= TOL
