"""The port's int8 path (``ops/quantized_matmul.py``, ``nn/quantized.py``)
against the JAX package, on the CPU.

Weights and inputs come from numpy seeds and go to both packages.
Limits: per-channel codes and scales bit-equal; the int32 accumulators
exact (against an exact float64 product); outputs within 1e-6 of the
largest |y| (the same int32 sums, then the same f32 products: equal in
practice).  A model with a BN folded into its conv computes the fold's
``rsqrt`` in each package, which may differ in the last bit; its limit
is 1e-5 of the largest |y|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.nn import fused as JF
from bigdl_tpu.nn import quantized as JQ
from bigdl_tpu.ops import quantized_matmul as JM
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.nn import fused as TF
from bigdl_tpu_torch.nn import quantized as TQ
from bigdl_tpu_torch.ops import quantized_matmul as TM
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

OUT_REL = 1e-6
FOLD_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("shape", [(16, 32), (8, 3, 3, 3), (5, 7)])
def test_quantize_per_channel_bit_equal(shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[0] = 0.0                                      # the 1e-8 floor
    jq, js = JM.quantize_per_channel(jnp.asarray(w), axis=0)
    tq, ts = TM.quantize_per_channel(_t(w), axis=0)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("impl", ["int8", "dequant", "auto"])
@pytest.mark.parametrize("x_shape", [(8, 64), (2, 1, 64), (3, 5, 64)])
def test_int8_matmul_matches_jax(impl, x_shape):
    rs = np.random.RandomState(1)
    x = rs.randn(*x_shape).astype(np.float32)
    w = rs.randn(24, 64).astype(np.float32)
    jq, js = JM.quantize_per_channel(jnp.asarray(w))
    want = JM.int8_matmul(jnp.asarray(x), jq, js, impl=impl)
    tq, ts = TM.quantize_per_channel(_t(w))
    got = TM.int8_matmul(_t(x), tq, ts, impl=impl, device="cpu")
    assert _rel(got, want) <= OUT_REL


def test_int8_matmul_with_given_scale():
    rs = np.random.RandomState(2)
    xq = rs.randint(-127, 128, (9, 40)).astype(np.int8)
    xs = (rs.rand(9, 1).astype(np.float32) + 0.5) / 127
    w = rs.randn(16, 40).astype(np.float32)
    jq, js = JM.quantize_per_channel(jnp.asarray(w))
    tq, ts = TM.quantize_per_channel(_t(w))
    for impl in ("int8", "dequant"):
        want = JM.int8_matmul(jnp.asarray(xq), jq, js, x_scale=xs,
                              impl=impl)
        got = TM.int8_matmul(torch.from_numpy(xq), tq, ts,
                             x_scale=_t(xs), impl=impl, device="cpu")
        assert _rel(got, want) <= OUT_REL


@pytest.mark.parametrize("m,k,n", [(8, 512, 512), (8, 147, 64),
                                   (30, 4608, 8), (1, 3, 5)])
def test_int8_mm_accumulators_exact(m, k, n):
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (n, k)).astype(np.int8))
    got = TM.int8_mm(a, w)
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TM.int8_mm_plain(a, w).numpy(), want)


def test_int8_matmul_refuses_what_it_cannot_do():
    x = torch.zeros(2, 8)
    q, s = TM.quantize_per_channel(torch.ones(4, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.int8_matmul(x, q, s)
    with pytest.raises(ValueError, match="impl"):
        TM.int8_matmul(x, q, s, impl="fp8", device="cpu")
    with pytest.raises(TypeError, match="int8"):
        TM.int8_mm(torch.zeros(2, 8), q)


def test_quantized_linear_matches_jax():
    rs = np.random.RandomState(4)
    w = rs.randn(16, 32).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    x = rs.randn(8, 32).astype(np.float32)
    want = JQ.QuantizedLinear(jnp.asarray(w), jnp.asarray(b)).forward(x)
    q = TQ.QuantizedLinear(_t(w), _t(b))
    assert _rel(q(_t(x)), want) <= OUT_REL
    assert set(q.params()) == {"weight_q", "weight_scale", "bias"}


# (in, out, k, stride, pads, groups, dilation), as the JAX package's
# tests/test_quantized.py:30, :82 and :126 cover them
CONV_CASES = [
    (8, 16, 1, (1, 1), [(0, 0), (0, 0)], 1, (1, 1)),
    (8, 16, 1, (2, 2), [(0, 0), (0, 0)], 1, (1, 1)),
    (3, 8, 3, (1, 1), [(1, 1), (1, 1)], 1, (1, 1)),
    (6, 8, 3, (2, 2), [(1, 1), (1, 1)], 1, (1, 1)),
    (3, 6, 3, (1, 1), [(2, 2), (2, 2)], 1, (2, 2)),
    (3, 8, 7, (2, 2), [(3, 3), (3, 3)], 1, (1, 1)),
    (4, 6, 3, (1, 1), [(1, 0), (0, 1)], 2, (1, 1)),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_quantized_conv_matches_jax(case):
    cin, cout, k, stride, pads, groups, dil = case
    rs = np.random.RandomState(5)
    w = rs.randn(cout, cin // groups, k, k).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    x = rs.randn(2, cin, 11, 10).astype(np.float32)
    want = JQ.QuantizedSpatialConvolution(
        jnp.asarray(w), jnp.asarray(b), stride, pads, groups,
        dil).forward(x)
    got = TQ.QuantizedSpatialConvolution(_t(w), _t(b), stride, pads,
                                         groups, dil)(_t(x))
    assert _rel(got, want) <= OUT_REL


def _pair(build_j, build_t):
    """The same model in both packages, the port's carrying JAX's
    weights and BN state."""
    jm = build_j()
    tm = build_t()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))
    return jm, tm


def _chain(P, L):
    return P.Sequential() \
        .add(L.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1)) \
        .add(L.SpatialBatchNormalization(8)).add(L.ReLU()) \
        .add(L.SpatialDilatedConvolution(8, 4, 3, 3, 1, 1, 2, 2, 2, 2)) \
        .add(L.Reshape([4 * 8 * 8])).add(L.Linear(4 * 8 * 8, 10)) \
        .add(L.LogSoftMax())


def test_quantize_sequential_matches_jax():
    """quantize() swaps the convs and the Linear; the float BN stays,
    run in eval mode on its running statistics."""
    jm, tm = _pair(lambda: _chain(JN, JN), lambda: _chain(TN, TN))
    rs = np.random.RandomState(6)
    st = jm.state()
    st["1"]["running_mean"] = jnp.asarray(rs.randn(8).astype(np.float32))
    st["1"]["running_var"] = jnp.asarray(rs.rand(8).astype(np.float32) + .5)
    jm.set_state(st)
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))
    jm.evaluate()
    tm.evaluate()
    x = rs.randn(2, 3, 8, 8).astype(np.float32)
    jq, tq = JQ.quantize(jm), TQ.Quantizer.quantize(tm)
    assert [type(m).__name__ for m in tq.modules] == \
        [type(m).__name__ for m in jq.modules]
    assert isinstance(tm.modules[0], TN.SpatialConvolution)  # a copy
    assert _rel(tq(_t(x)), jq.forward(x)) <= OUT_REL


@pytest.mark.parametrize("kernel,with_relu", [(1, True), (3, False)])
def test_quantize_folds_fused_conv_bn_like_jax(kernel, with_relu):
    """tests/test_quantized.py:143 in both packages: the fused conv+BN
    folds its running statistics into int8 conv weights."""
    pad = (kernel - 1) // 2

    def build(P, L):
        conv = L.SpatialConvolution(8, 16, kernel, kernel, 1, 1, pad, pad,
                                    with_bias=False)
        m = P.Sequential().add(conv).add(L.SpatialBatchNormalization(16))
        if with_relu:
            m.add(L.ReLU())
        return m

    jm, tm = _pair(lambda: build(JN, JN), lambda: build(TN, TN))
    JF.fuse_conv_bn(jm)
    TF.fuse_conv_bn(tm)
    rs = np.random.RandomState(31)
    st = jax.tree.map(np.asarray, jm.state())
    st["0"]["running_mean"] = rs.randn(16).astype(np.float32) * 0.3
    st["0"]["running_var"] = rs.rand(16).astype(np.float32) * 2 + 0.5
    jm.set_state(jax.tree.map(jnp.asarray, st))
    load_jax_state(tm, st)
    jm.evaluate()
    tm.evaluate()
    x = rs.randn(2, 8, 10, 10).astype(np.float32)
    jq, tq = JQ.quantize(jm), TQ.quantize(tm)
    assert [type(m).__name__ for m in tq.modules] == \
        [type(m).__name__ for m in jq.modules]
    assert _rel(tq(_t(x)), jq.forward(x)) <= FOLD_REL


def test_quantize_graph_keeps_its_wiring():
    rs = np.random.RandomState(3)
    w = rs.randn(3, 6).astype(np.float32)
    inp = TN.Input("x")
    fc = TN.Linear(6, 3)(inp)
    g = TN.Graph(inp, fc)
    lin = [m for m in g.modules if isinstance(m, TN.Linear)][0]
    lin.set_params({"weight": _t(w), "bias": _t(np.zeros(3))})
    x = rs.randn(2, 6).astype(np.float32)
    qg = TQ.quantize(g)
    assert any(isinstance(m, TQ.QuantizedLinear) for m in qg.modules)
    want = JQ.QuantizedLinear(jnp.asarray(w), jnp.zeros(3)).forward(x)
    assert _rel(qg(_t(x)), want) <= OUT_REL


def test_quantized_backward_raises():
    q = TQ.QuantizedLinear(torch.ones(4, 4))
    with pytest.raises(RuntimeError, match="inference-only"):
        q.backward(torch.ones(2, 4), torch.ones(2, 4))
    jq = JQ.QuantizedLinear(np.ones((4, 4), np.float32))
    with pytest.raises(RuntimeError, match="inference-only"):
        jq.backward(np.ones((2, 4), np.float32), np.ones((2, 4), np.float32))
