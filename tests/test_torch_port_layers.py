"""The rest of the JAX package's layers in the port, on the CPU.

Every layer class of ``bigdl_tpu/nn/layers.py`` that the port lacked
before this slice: forward, input gradient and parameter gradients
against ``jax.vjp`` of the JAX layer within 1e-5 of the largest |JAX
value|, on the same random parameters (``load_jax_params``), integer
outputs (``ArgMax``, ``Round``, ``Sign``, ``Floor``, ``Ceil``, ``Index``
of an integer table) exactly; seeded layers draw the JAX numbers; the
init methods draw them too.  The hazards the port copies are pinned
both ways (the port equals JAX, the tempting alternative does not):
``SpatialUpSamplingBilinear``'s half-pixel antialiased resize, the tanh
``GELU``, ``Max``'s split gradient at ties, SAME padding's odd cell,
and the gradients of ``GradientReversal`` and ``L1Penalty``;
``ConvLSTMPeephole`` with and without peepholes through ``Recurrent``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.nn.layers import same_pads

from torch_port_parity import (TOL, carry, check_module, randomize_params,
                               rel, to_np)


def _n(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _p(*shape, seed=0):
    return np.abs(_n(*shape, seed=seed)) + 0.1


def _ids(n, hi, seed=0, shape=None):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, hi, shape or (n,)) + 1).astype(np.float32)


def _masked(seed=0):
    x = _n(3, 4, 5, seed=seed)
    x[0, 1] = 0.0
    x[2, 3] = 0.0
    return x


# (id, class, constructor arguments, input maker, exact outputs)
CASES = [
    ("temporal", "TemporalConvolution", (6, 5, 3), lambda: _n(2, 9, 6), 0),
    ("temporal-s2", "TemporalConvolution", (6, 5, 3, 2), lambda: _n(2, 10, 6),
     0),
    ("temporal-unbatched", "TemporalConvolution", (4, 3, 2),
     lambda: _n(7, 4), 0),
    ("temporal-nobias", "TemporalConvolution", (4, 3, 2, 1, False),
     lambda: _n(2, 7, 4), 0),
    ("max", "Max", (2,), lambda: _n(3, 5, 4), 0),
    ("min", "Min", (3,), lambda: _n(3, 5, 4), 0),
    ("mean", "Mean", (2,), lambda: _n(3, 5, 4), 0),
    ("mean-batched-keep", "Mean", (2, 2, False), lambda: _n(3, 5, 4), 0),
    ("sum", "Sum", (1,), lambda: _n(3, 5, 4), 0),
    ("sum-avg", "Sum", (2, 2, True), lambda: _n(3, 5, 4), 0),
    ("relu6", "ReLU6", (), lambda: _n(4, 7, scale=5.0), 0),
    ("hardtanh", "HardTanh", (-0.5, 0.7), lambda: _n(4, 7), 0),
    ("clamp", "Clamp", (-0.3, 0.4), lambda: _n(4, 7), 0),
    ("threshold", "Threshold", (0.1, -2.0), lambda: _n(4, 7), 0),
    ("hardsigmoid", "HardSigmoid", (), lambda: _n(4, 7, scale=4.0), 0),
    ("softmin", "SoftMin", (), lambda: _n(4, 7), 0),
    ("softsign", "SoftSign", (), lambda: _n(4, 7), 0),
    ("gelu", "GELU", (), lambda: _n(4, 7, scale=2.0), 0),
    ("selu", "SELU", (), lambda: _n(4, 7), 0),
    ("square", "Square", (), lambda: _n(4, 7), 0),
    ("sqrt", "Sqrt", (), lambda: _p(4, 7), 0),
    ("negative", "Negative", (), lambda: _n(4, 7), 0),
    ("floor", "Floor", (), lambda: _n(4, 7, scale=3.0), 1),
    ("ceil", "Ceil", (), lambda: _n(4, 7, scale=3.0), 1),
    ("round", "Round", (), lambda: np.array(
        [[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.7]], np.float32), 1),
    ("sign", "Sign", (), lambda: np.array(
        [[-2.0, 0.0, 3.0, -0.0, 1e-30]], np.float32), 1),
    ("log1p", "Log1p", (), lambda: _p(4, 7), 0),
    ("expm1", "Expm1", (), lambda: _n(4, 7), 0),
    ("erf", "Erf", (), lambda: _n(4, 7), 0),
    ("sin", "Sin", (), lambda: _n(4, 7, scale=3.0), 0),
    ("cos", "Cos", (), lambda: _n(4, 7, scale=3.0), 0),
    ("argmax", "ArgMax", (2,), lambda: np.array(
        [[1.0, 3.0, 3.0, 0.0], [2.0, -1.0, 0.5, 2.5]], np.float32), 1),
    ("argmax-last", "ArgMax", (-1,), lambda: _n(3, 4, 5), 1),
    ("addconstant", "AddConstant", (1.5,), lambda: _n(4, 7), 0),
    ("divconstant", "DivConstant", (3.0,), lambda: _n(4, 7), 0),
    ("mulconstant", "MulConstant", (-2.5,), lambda: _n(4, 7), 0),
    ("cmul", "CMul", ((1, 5),), lambda: _n(3, 5), 0),
    ("cadd", "CAdd", ((3, 1),), lambda: _n(2, 3, 4), 0),
    ("add", "Add", (5,), lambda: _n(3, 5), 0),
    ("mul", "Mul", (), lambda: _n(3, 5), 0),
    ("cosine", "Cosine", (5, 4), lambda: _n(3, 5), 0),
    ("euclidean", "Euclidean", (5, 4), lambda: _n(3, 5), 0),
    ("bilinear", "Bilinear", (4, 3, 5), lambda: (_n(3, 4), _n(3, 3, seed=1)),
     0),
    ("bilinear-nobias", "Bilinear", (4, 3, 5, False),
     lambda: (_n(3, 4), _n(3, 3, seed=1)), 0),
    ("squeeze", "Squeeze", (2,), lambda: _n(3, 1, 4), 0),
    ("squeeze-all", "Squeeze", (), lambda: _n(3, 1, 4, 1), 0),
    ("unsqueeze", "Unsqueeze", (2,), lambda: _n(3, 4), 0),
    ("transpose", "Transpose", ([[1, 3], [2, 3]],), lambda: _n(2, 3, 4), 0),
    ("contiguous", "Contiguous", (), lambda: _n(2, 3, 4), 0),
    ("replicate", "Replicate", (3, 2), lambda: _n(2, 4), 0),
    ("narrow", "Narrow", (2, 2, 3), lambda: _n(3, 6), 0),
    ("narrow-neg", "Narrow", (-1, 2, -2), lambda: _n(3, 6), 0),
    ("padding", "Padding", (1, 2, 1, 0.5), lambda: _n(3, 4), 0),
    ("padding-before", "Padding", (2, -3, 2), lambda: _n(2, 3, 4), 0),
    ("zeropad", "SpatialZeroPadding", (1, 2, 0, 3), lambda: _n(2, 3, 4, 5),
     0),
    ("zeropad-one", "SpatialZeroPadding", (1,), lambda: _n(3, 4, 5), 0),
    ("index", "Index", (1,), lambda: (_n(5, 4), _ids(3, 5)), 0),
    ("index-2d", "Index", (2,), lambda: (_n(3, 6, 2), _ids(0, 6,
                                                           shape=(2, 2))), 0),
    ("masking", "Masking", (0.0,), _masked, 0),
    ("upnearest", "SpatialUpSamplingNearest", (2,), lambda: _n(2, 3, 4, 5),
     0),
    ("upbilinear-up", "SpatialUpSamplingBilinear", (8, 10),
     lambda: _n(2, 3, 4, 5), 0),
    ("upbilinear-down", "SpatialUpSamplingBilinear", (3, 3),
     lambda: _n(2, 3, 7, 8), 0),
    ("upbilinear-mixed", "SpatialUpSamplingBilinear", (9, 3),
     lambda: _n(3, 4, 7), 0),
    ("normalize", "Normalize", (2.0,), lambda: _n(3, 5), 0),
    ("normalize-inf", "Normalize", (float("inf"),), lambda: _n(3, 5), 0),
    ("normalize-1.5", "Normalize", (1.5,), lambda: _n(3, 5, 2), 0),
    ("gradreversal", "GradientReversal", (0.7,), lambda: _n(3, 5), 0),
    ("l1penalty", "L1Penalty", (0.3,), lambda: _n(3, 5), 0),
    ("l1penalty-avg", "L1Penalty", (0.3, True), lambda: _n(3, 5), 0),
    ("conv-same", "SpatialConvolution", (3, 4, 3, 3, 1, 1, -1, -1),
     lambda: _n(2, 3, 7, 7), 0),
    ("conv-same-s2-odd", "SpatialConvolution", (3, 4, 3, 3, 2, 2, -1, -1),
     lambda: _n(2, 3, 8, 8), 0),
    ("conv-same-k4", "SpatialConvolution", (3, 4, 4, 2, 1, 2, -1, 0),
     lambda: _n(2, 3, 6, 7), 0),
]


def _pair(name, args, seed=7):
    JRandom.RNG.set_seed(seed)
    jm = getattr(JN, name)(*args)
    TRandom.RNG.set_seed(seed)
    tm = getattr(TN, name)(*args)
    return jm, tm


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case):
    _, name, args, make, exact = case
    jm, tm = _pair(name, args)
    # seeded from one seed, both packages draw the same weights
    for n, v in jm.params().items():
        np.testing.assert_array_equal(to_np(getattr(tm, n)), np.asarray(v))
    carry(jm, tm)
    if jm.params():
        randomize_params(jm, tm)
    check_module(jm.evaluate(), tm.evaluate(), make(), exact=bool(exact))


@pytest.mark.parametrize("name,args", [
    ("Ones", ()), ("ConstInitMethod", (0.25,)), ("RandomUniform", ()),
    ("RandomUniform", (-0.2, 0.5)), ("RandomNormal", (0.1, 0.3))])
def test_init_methods_draw_the_jax_numbers(name, args):
    JRandom.RNG.set_seed(3)
    want = getattr(JN, name)(*args).init((4, 6), 6, 4)
    TRandom.RNG.set_seed(3)
    got = getattr(TN, name)(*args).init((4, 6), 6, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # a layer built with one draws the same weight in both packages
    JRandom.RNG.set_seed(4)
    jl = JN.Linear(6, 4, init_method=getattr(JN, name)(*args))
    TRandom.RNG.set_seed(4)
    tl = TN.Linear(6, 4, init_method=getattr(TN, name)(*args))
    np.testing.assert_array_equal(to_np(tl.weight), np.asarray(jl.weight))


@pytest.mark.parametrize("name", ["RandomUniform", "RandomNormal"])
def test_init_from_a_torch_generator(name):
    """With a ``torch.Generator`` the draw is torch's, reproducible from
    the generator's seed, and the shared RNG is left alone."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return getattr(TN, name)(generator=gen).init((5, 3), 3, 5)

    TRandom.RNG.set_seed(9)
    a = draw(1)
    after = TRandom.RNG.uniform(0, 1)
    TRandom.RNG.set_seed(9)
    assert TRandom.RNG.uniform(0, 1) == after
    assert a.shape == (5, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, draw(1))
    assert not np.array_equal(a, draw(2))
    if name == "RandomUniform":
        assert np.abs(a).max() <= 1 / np.sqrt(3)


def _bilinear_pair(x, size):
    jm, tm = _pair("SpatialUpSamplingBilinear", size)
    want = np.asarray(jm.apply({}, {}, jnp.asarray(x))[0])
    got = to_np(tm(torch.from_numpy(x)))
    return got, want


@pytest.mark.parametrize("size,shape", [((8, 10), (2, 3, 4, 5)),
                                        ((3, 3), (2, 3, 7, 8))])
def test_bilinear_is_half_pixel_not_align_corners(size, shape):
    """The JAX docstring says align_corners=true; the JAX layer samples
    at half pixels, antialiased when it shrinks.  The port follows what
    it does."""
    x = _n(*shape, seed=3)
    got, want = _bilinear_pair(x, size)
    assert rel(got, want) <= 1e-6
    xt = torch.from_numpy(x)
    corners = F.interpolate(xt, size=size, mode="bilinear",
                            align_corners=True).numpy()
    assert np.abs(corners - want).max() > 0.05
    if size[0] < shape[2]:
        plain = F.interpolate(xt, size=size, mode="bilinear",
                              align_corners=False).numpy()
        assert np.abs(plain - want).max() > 0.05


def test_gelu_is_the_tanh_form():
    x = _n(1000, scale=3.0)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = to_np(TN.GELU()(torch.from_numpy(x)))
    assert np.abs(got - want).max() <= 1e-6
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_tied_extrema_split_the_gradient(name):
    """[1, 1, 0] (max) gives [.5, .5, 0] in both packages; a ReLU'd
    channel dead over a whole document is all tied zeros."""
    x = np.array([[[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]]], np.float32)
    if name == "Min":
        x = -x
    jm = getattr(JN, name)(2)
    g_want = np.asarray(jax.grad(
        lambda v: jnp.sum(jm.apply({}, {}, v)[0]))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    getattr(TN, name)(2)(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), g_want)
    np.testing.assert_array_equal(g_want[0, :, 0], [0.5, 0.5, 0.0])
    np.testing.assert_array_equal(g_want[0, :, 1],
                                  np.full(3, 1 / 3, np.float32))
    xv = torch.tensor(x, requires_grad=True)
    (xv.max(dim=1).values if name == "Max" else xv.min(dim=1).values) \
        .sum().backward()
    assert not np.array_equal(xv.grad.numpy(), g_want)


def test_same_padding_puts_the_odd_cell_last():
    assert same_pads(8, 3, 2) == (0, 1)
    assert same_pads(7, 3, 1) == (1, 1)
    assert same_pads(6, 4, 1) == (1, 2)
    assert same_pads(5, 1, 2) == (0, 0)
    jm, tm = _pair("SpatialConvolution", (3, 4, 3, 3, 2, 2, -1, -1))
    carry(jm, tm)
    x = _n(2, 3, 8, 8, seed=2)
    want = np.asarray(jm.apply(jm.params(), {}, jnp.asarray(x))[0])
    got = to_np(tm(torch.from_numpy(x)))
    assert got.shape == (2, 4, 4, 4) and rel(got, want) <= TOL
    # the odd cell in front instead is another function
    front = F.conv2d(F.pad(torch.from_numpy(x), (1, 0, 1, 0)), tm.weight,
                     tm.bias, stride=2)
    assert rel(front, want) > 1e-2


def test_lookup_table_reads_ids_as_jnp_take():
    """Id 0, the text pipeline's padding, reads the last row in JAX
    (``jnp.take`` counts a negative index from the end); an id outside
    [1 - n, n] reads NaN.  The text CNN's documents end in 0 ids."""
    jm, tm = _pair("LookupTable", (5, 3))
    ids = np.array([[0, 1, 5, -4, 6, -5, 2]], np.float32)
    want = np.asarray(jm.apply(jm.params(), {}, jnp.asarray(ids))[0])
    got = to_np(tm(torch.from_numpy(ids)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], to_np(tm.weight)[-1])
    assert np.isnan(got[0, 4]).all() and np.isnan(got[0, 5]).all()
    check_module(jm, tm, ids[:, :4])


def test_gradient_reversal_and_l1_penalty_gradients():
    x = torch.tensor(_n(3, 4, seed=4), requires_grad=True)
    g = torch.from_numpy(_n(3, 4, seed=5))
    y = TN.GradientReversal(0.7)(x)
    assert torch.equal(y, x)
    y.backward(g)
    assert torch.allclose(x.grad, -0.7 * g)
    for avg, w in ((False, 0.3), (True, 0.3 / 12)):
        x.grad = None
        y = TN.L1Penalty(0.3, avg)(x)
        assert torch.equal(y, x)
        y.backward(g)
        assert torch.allclose(x.grad, g + w * torch.sign(x.detach()))
    m = TN.GradientReversal().set_lambda(2.0)
    x.grad = None
    m(x).backward(g)
    assert torch.allclose(x.grad, -2.0 * g)


@pytest.mark.parametrize("peephole,k_i,k_c", [(True, 3, 3), (False, 3, 3),
                                              (True, 2, 3)])
def test_conv_lstm_peephole_matches_jax(peephole, k_i, k_c):
    args = (2, 3, k_i, k_c, 1, peephole)
    JRandom.RNG.set_seed(11)
    jm = JN.Recurrent().add(JN.ConvLSTMPeephole(*args))
    TRandom.RNG.set_seed(11)
    tm = TN.Recurrent().add(TN.ConvLSTMPeephole(*args))
    for n, v in jm.params()["0"].items():
        np.testing.assert_array_equal(to_np(getattr(tm.cell, n)),
                                      np.asarray(v))
    names = {"w_i", "w_h", "b"} | ({"p_i", "p_f", "p_o"} if peephole
                                   else set())
    assert set(tm.params()["0"]) == names
    carry(jm, tm)
    randomize_params(jm, tm)
    check_module(jm, tm, _n(2, 3, 2, 5, 5, seed=6))
    # one timestep alone (the cell's own forward) is the sequence's first
    with torch.no_grad():
        x = torch.from_numpy(_n(2, 3, 2, 5, 5, seed=6))
        assert torch.allclose(tm.cell(x[:, 0]), tm(x)[:, 0], atol=1e-6)
    with pytest.raises(ValueError, match="stride=1"):
        TN.ConvLSTMPeephole(2, 3, stride=2)
