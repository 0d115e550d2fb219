"""``bigdl_tpu/nn/layers_extra.py``'s 46 classes in the port, on the
CPU.

Each class: forward, input gradient and parameter gradients against
``jax.vjp`` of the JAX layer within 1e-5 of the largest |JAX value|, on
the same random parameters (``load_jax_params``), seeded ones drawing
the JAX numbers; the layers whose output is boolean or sized by the
data (``CompareConstant``, ``MaskedSelect``, ``GatherIndices`` out of
range) exactly, forward only, as JAX cannot differentiate them.  The
random layers equal JAX in eval mode; in training mode the port's map,
given the noise it drew, is JAX's formula, and the noise's mean and
variance over >= 1e5 draws lie within 3 standard errors of its law
(the spatial masks constant over the dropped dims).  Pins: the
resizes' coordinates (not ``F.interpolate``'s) and the half-to-even
round at an exact .5 source coordinate, ``RoiPooling``'s rounding and
its gradient split at tied maxima.
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

from torch_port_parity import (carry, check_module, check_spec_and_files,
                               randomize_params, to_np)


def _n(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _p(*shape, seed=0):
    return np.abs(_n(*shape, seed=seed)) + 0.1


def _rois():
    return np.array([[1, 0, 0, 9, 7], [2, 2.4, 3.0, 15.2, 18.0],
                     [1, 5, 5, 5, 5], [2, 7.5, 1.5, 19, 11]], np.float32)


# (id, class, constructor arguments, input maker)
CASES = [
    ("lc1d", "LocallyConnected1D", (9, 4, 5, 3, 2), lambda: _n(2, 9, 4)),
    ("lc1d-unbatched", "LocallyConnected1D", (7, 3, 2, 2),
     lambda: _n(7, 3)),
    ("lc1d-nobias", "LocallyConnected1D", (8, 3, 4, 3, 1, False),
     lambda: _n(2, 8, 3)),
    ("lc2d", "LocallyConnected2D", (3, 7, 5, 4, 3, 2, 2, 1, 1, 0),
     lambda: _n(2, 3, 5, 7)),
    ("lc2d-pad", "LocallyConnected2D", (2, 6, 8, 3, 2, 3, 1, 2, 0, 1),
     lambda: _n(2, 2, 8, 6)),
    ("separable", "SpatialSeparableConvolution", (3, 5, 2, 3, 3, 1, 1, 1, 1),
     lambda: _n(2, 3, 6, 7)),
    ("separable-same", "SpatialSeparableConvolution",
     (3, 4, 2, 3, 2, 2, 2, -1, -1), lambda: _n(2, 3, 7, 6)),
    ("share", "SpatialShareConvolution", (3, 4, 3, 3, 1, 1, 1, 1),
     lambda: _n(2, 3, 6, 6)),
    ("conv-map", "SpatialConvolutionMap",
     ([[1, 1], [2, 1], [2, 2], [3, 2]], 3, 3), lambda: _n(2, 3, 6, 7)),
    ("conv-map-s2", "SpatialConvolutionMap",
     ([[1, 1], [1, 2], [2, 3]], 2, 3, 2, 1, 1, 0), lambda: _n(2, 2, 7, 6)),
    ("tmax", "TemporalMaxPooling", (3, 2), lambda: _n(2, 9, 4)),
    ("tavg", "TemporalAveragePooling", (3,), lambda: _n(2, 9, 4)),
    ("softshrink", "SoftShrink", (0.3,), lambda: _n(4, 7)),
    ("hardshrink", "HardShrink", (0.4,), lambda: _n(4, 7)),
    ("tanhshrink", "TanhShrink", (), lambda: _n(4, 7)),
    ("logsigmoid", "LogSigmoid", (), lambda: _n(4, 7, scale=4.0)),
    ("rrelu", "RReLU", (), lambda: _n(4, 7)),
    ("gaussian-dropout", "GaussianDropout", (0.3,), lambda: _n(4, 7)),
    ("gaussian-noise", "GaussianNoise", (0.2,), lambda: _n(4, 7)),
    ("gaussian-sampler", "GaussianSampler", (),
     lambda: (_n(3, 4), _n(3, 4, seed=1))),
    ("sdrop1", "SpatialDropout1D", (0.4,), lambda: _n(2, 5, 3)),
    ("sdrop2", "SpatialDropout2D", (0.4,), lambda: _n(2, 3, 4, 4)),
    ("sdrop3", "SpatialDropout3D", (0.4,), lambda: _n(2, 3, 2, 3, 3)),
    ("crop2d", "Cropping2D", ((1, 2), (0, 1)), lambda: _n(2, 3, 6, 7)),
    ("up1d", "UpSampling1D", (3,), lambda: _n(2, 4, 3)),
    ("up2d", "UpSampling2D", ((2, 3),), lambda: _n(2, 2, 3, 4)),
    ("bilinear", "ResizeBilinear", (5, 7), lambda: _n(2, 2, 4, 3)),
    ("bilinear-align", "ResizeBilinear", (5, 7, True),
     lambda: _n(2, 2, 4, 3)),
    ("bilinear-half", "ResizeBilinear", (5, 7, False, True),
     lambda: _n(2, 2, 4, 3)),
    ("bilinear-down", "ResizeBilinear", (3, 2, False, True),
     lambda: _n(2, 2, 6, 5)),
    ("nearest", "ResizeNearestNeighbor", (5, 7), lambda: _n(2, 2, 4, 3)),
    ("nearest-align", "ResizeNearestNeighbor", (3, 5, True),
     lambda: _n(2, 2, 6, 9)),
    ("nearest-half", "ResizeNearestNeighbor", (5, 7, False, True),
     lambda: _n(2, 2, 4, 3)),
    ("d2s", "DepthToSpace", (2,), lambda: _n(2, 8, 3, 4)),
    ("s2d", "SpaceToDepth", (2,), lambda: _n(2, 3, 4, 6)),
    ("lrn-within", "SpatialWithinChannelLRN", (3, 0.5, 0.75),
     lambda: _n(2, 3, 5, 6)),
    ("lrn-within-even", "SpatialWithinChannelLRN", (4, 1.0, 0.6),
     lambda: _n(2, 2, 5, 6)),
    ("subtractive", "SpatialSubtractiveNormalization", (3,),
     lambda: _n(2, 3, 8, 9)),
    ("subtractive-1d", "SpatialSubtractiveNormalization",
     (2, [1.0, 2.0, 3.0, 2.0]), lambda: _n(2, 2, 6, 7)),
    ("divisive", "SpatialDivisiveNormalization", (2, np.ones((3, 3))),
     lambda: _n(2, 2, 6, 7)),
    ("contrastive", "SpatialContrastiveNormalization",
     (2, [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]),
     lambda: _n(2, 2, 6, 7)),
    ("expand", "ExpandSize", ([3, -1, 4],), lambda: _n(1, 5, 1)),
    ("infer-reshape", "InferReshape", ([0, -1, 2], True),
     lambda: _n(2, 3, 4, 2)),
    ("infer-reshape-plain", "InferReshape", ([-1, 0],), lambda: _n(6, 4)),
    ("tile", "Tile", (2, 3), lambda: _n(2, 3, 4)),
    ("tile-neg", "Tile", (-1, 2), lambda: _n(2, 3, 4)),
    ("split-chunks", "SplitChunks", (2, 2), lambda: _n(3, 4, 5)),
    ("gather", "GatherIndices", (2, [2, 0, 1, -1]), lambda: _n(3, 4, 5)),
    ("reverse", "Reverse", (2,), lambda: _n(3, 4, 5)),
    ("cumsum", "CumSum", (2,), lambda: _n(3, 5, 4)),
    ("cumsum-excl", "CumSum", (2, True), lambda: _n(3, 5, 4)),
    ("cumsum-rev", "CumSum", (3, False, True), lambda: _n(3, 5, 4)),
    ("cumsum-excl-rev", "CumSum", (1, True, True), lambda: _n(3, 5, 4)),
    ("fill-like", "FillLike", (1.5,), lambda: _n(3, 4)),
    ("mirror-reflect", "MirrorPad", ([[0, 0], [1, 2], [2, 1]],),
     lambda: _n(2, 4, 5)),
    ("mirror-symmetric", "MirrorPad", ([[1, 0], [2, 2], [0, 3]],
                                       "SYMMETRIC"), lambda: _n(2, 4, 5)),
    ("pairwise-l2", "PairwiseDistance", (2,),
     lambda: (_n(4, 5), _n(4, 5, seed=1))),
    ("pairwise-l3", "PairwiseDistance", (3,),
     lambda: (_n(4, 5), _n(4, 5, seed=1))),
    ("maxout", "Maxout", (6, 4, 3), lambda: _n(5, 6)),
    ("maxout-unbatched", "Maxout", (6, 4, 2, False), lambda: _n(6)),
    ("highway", "Highway", (5,), lambda: _n(4, 5)),
    ("highway-tanh", "Highway", (5, True, "Tanh"), lambda: _n(4, 5)),
    ("highway-nobias", "Highway", (5, False), lambda: _n(4, 5)),
    ("srelu", "SReLU", ((4,),), lambda: _n(3, 4, scale=2.0)),
    ("srelu-2d", "SReLU", ((2, 3),), lambda: _n(5, 2, 3, scale=2.0)),
    ("roi", "RoiPooling", (3, 2, 0.5),
     lambda: (_n(2, 3, 12, 10), _rois())),
    ("roi-scale1", "RoiPooling", (2, 3),
     lambda: (_n(2, 2, 20, 20), _rois())),
    ("entropy", "NegativeEntropyPenalty", (0.1,), lambda: _n(3, 4)),
]


def _pair(name, args, seed=7):
    JRandom.RNG.set_seed(seed)
    jm = getattr(JN, name)(*args)
    TRandom.RNG.set_seed(seed)
    tm = getattr(TN, name)(*args)
    return jm, tm


def test_cases_cover_every_class():
    from bigdl_tpu.nn import layers_extra as JX

    # CompareConstant and MaskedSelect: the exact forward-only tests
    assert {c[1] for c in CASES} | {"CompareConstant", "MaskedSelect"} == \
        set(JX.__all__)
    assert len(JX.__all__) == 46


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case):
    _, name, args, make = case
    jm, tm = _pair(name, args)
    for n, v in jm.params().items():
        if v is not None:
            np.testing.assert_array_equal(to_np(getattr(tm, n)),
                                          np.asarray(v))
    carry(jm, tm)
    if jm.params():
        randomize_params(jm, tm)
    # JAX's generic reduce_window (TemporalAveragePooling) linearizes
    # only outside jit
    check_module(jm.evaluate(), tm.evaluate(), make(),
                 jit=name != "TemporalAveragePooling")


def _forward_pair(name, args, x):
    jm, tm = _pair(name, args)
    jx = tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) \
        else jnp.asarray(x)
    tx = tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple) \
        else torch.from_numpy(x)
    want = jm.evaluate().forward(jx)
    with torch.no_grad():
        got = tm.evaluate()(tx)
    return to_np(got), np.asarray(want)


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
@pytest.mark.parametrize("const_first", [False, True])
def test_compare_constant_is_exact(op, const_first):
    x = np.round(_n(4, 6), 1)
    got, want = _forward_pair("CompareConstant", (op, 0.1, const_first), x)
    assert got.dtype == np.bool_ and want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_masked_select_and_gather_out_of_range_are_exact():
    x = _n(3, 5)
    mask = (np.random.RandomState(3).rand(3, 5) > 0.5).astype(np.float32)
    got, want = _forward_pair("MaskedSelect", (), (x, mask))
    np.testing.assert_array_equal(got, want)
    # jnp.take's fill: an index outside [-n, n) reads NaN
    got, want = _forward_pair("GatherIndices", (2, [0, 5, -5, -1]), x)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got).any()


def test_resize_coordinates_are_jax_not_interpolate():
    """The legacy TF coordinates (``dst·in/out``) are neither
    ``F.interpolate``'s half-pixel nor its corner-aligned ones."""
    x = _n(1, 2, 4, 3, seed=4)
    got, want = _forward_pair("ResizeBilinear", (5, 7), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    xt = torch.from_numpy(x)
    for ac in (False, True):
        other = F.interpolate(xt, size=(5, 7), mode="bilinear",
                              align_corners=ac).numpy()
        assert np.abs(other - want).max() > 0.05


def test_nearest_rounds_half_to_even():
    """align_corners from 6 rows to 3: row 1 samples 2.5, which
    ``jnp.round`` and ``torch.round`` both take to 2 (half to even),
    not 3 (half up)."""
    x = np.arange(6 * 2, dtype=np.float32).reshape(1, 1, 6, 2)
    got, want = _forward_pair("ResizeNearestNeighbor", (3, 2, True), x)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 1, 0] == x[0, 0, 2, 0] != x[0, 0, 3, 0]


def test_roi_pooling_rounding_and_tied_maxima():
    """The box rounds half to even (2.5 -> 2) and a bin of tied maxima
    splits its gradient equally, as ``jax.vjp`` of JAX's max does."""
    data = np.zeros((1, 1, 6, 6), np.float32)
    data[0, 0, 2:4, 2:4] = 1.0                 # four tied maxima
    rois = np.array([[1, 2.5, 2.5, 3.5, 3.5]], np.float32)
    jm, tm = _pair("RoiPooling", (1, 1, 1.0))
    y, vjp = jax.vjp(lambda d: jm.forward((d, jnp.asarray(rois))),
                     jnp.asarray(data))
    (gj,) = vjp(jnp.ones_like(y))
    d = torch.from_numpy(data).requires_grad_()
    out = tm((d, torch.from_numpy(rois)))
    out.sum().backward()
    np.testing.assert_array_equal(to_np(out), np.asarray(y))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gj), atol=1e-7)
    # x1 = round(2.5) = 2, x2 = round(3.5) = 4: the box spans 2..4
    assert np.count_nonzero(np.asarray(gj)) == 4
    np.testing.assert_allclose(d.grad.numpy()[0, 0, 2:4, 2:4], 0.25)


# ---- the random layers in training mode ------------------------------------
N_DRAWS = 200_000


def _within(samples, mean, var, what):
    s = np.asarray(samples, np.float64).reshape(-1)
    n = s.size
    assert n >= 1e5, what
    se_mean = np.sqrt(var / n)
    assert abs(s.mean() - mean) <= 3 * se_mean, (what, s.mean(), mean)
    # the sample variance's standard error from the fourth moment
    m4 = np.mean((s - s.mean()) ** 4)
    se_var = np.sqrt(max(m4 - var ** 2, 1e-30) / n)
    assert abs(s.var() - var) <= 3 * se_var, (what, s.var(), var)


def test_rrelu_training_draws_uniform_slopes():
    m = TN.RReLU(0.1, 0.4).train()
    x = -np.abs(_n(N_DRAWS, seed=5)) - 0.1
    y = m(torch.from_numpy(x), rng_seed=11).numpy()
    slope = y / x
    # JAX's formula on the drawn slope
    np.testing.assert_array_equal(np.asarray(jnp.where(
        jnp.asarray(x) >= 0, x, x * slope.astype(np.float32))), y)
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.4 + 1e-6
    _within(slope, 0.25, 0.3 ** 2 / 12, "slope")
    pos = np.abs(_n(100, seed=6))
    np.testing.assert_array_equal(
        m(torch.from_numpy(pos), rng_seed=11).numpy(), pos)
    again = m(torch.from_numpy(x), rng_seed=11).numpy()
    np.testing.assert_array_equal(again, y)


def test_gaussian_dropout_and_noise_laws():
    rate, std = 0.3, 0.2
    x = _p(N_DRAWS, seed=7)
    y = TN.GaussianDropout(rate).train()(torch.from_numpy(x),
                                         rng_seed=3).numpy()
    noise = y / x - 1.0
    _within(noise, 0.0, rate / (1 - rate), "gaussian dropout")
    y = TN.GaussianNoise(std).train()(torch.from_numpy(x),
                                      rng_seed=3).numpy()
    _within(y - x, 0.0, std ** 2, "gaussian noise")
    # without a seed both are the identity, as JAX without an rng
    np.testing.assert_array_equal(
        TN.GaussianNoise(std).train()(torch.from_numpy(x)).numpy(), x)


def test_gaussian_sampler_reparameterizes():
    mean = _n(N_DRAWS, seed=8)
    log_var = _n(N_DRAWS, seed=9, scale=0.5)
    y = TN.GaussianSampler()((torch.from_numpy(mean),
                              torch.from_numpy(log_var)), rng_seed=4)
    eps = (y.numpy() - mean) / np.exp(log_var * 0.5)
    _within(eps, 0.0, 1.0, "epsilon")
    want = np.asarray(jnp.asarray(mean) + jnp.exp(jnp.asarray(log_var) * 0.5)
                      * jnp.asarray(eps.astype(np.float32)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,shape,axes", [
    ("SpatialDropout1D", (500, 3, 200), (1,)),
    ("SpatialDropout2D", (200, 500, 2, 2), (2, 3)),
    ("SpatialDropout3D", (100, 1000, 2, 1, 2), (2, 3, 4))])
def test_spatial_dropout_masks_whole_maps(name, shape, axes):
    p = 0.4
    x = _p(*shape, seed=10)
    y = getattr(TN, name)(p).train()(torch.from_numpy(x), rng_seed=5).numpy()
    kept = y != 0
    # constant over the dropped dims
    assert np.all(kept == kept.any(axis=axes, keepdims=True))
    np.testing.assert_allclose(y[kept], x[kept] / (1 - p), rtol=1e-6)
    _within(kept.any(axis=axes), 1 - p, p * (1 - p), "kept maps")
    # the mask bits as JAX's formula uses them
    jy = jnp.where(jnp.asarray(kept), jnp.asarray(x), 0.0) / (1 - p)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-6)


# one case a class, for the files
FILE_CASES = list({c[1]: c for c in CASES}.values()) + [
    ("compare", "CompareConstant", ("ge", 0.5, True), None),
    ("masked-select", "MaskedSelect", (), None)]


@pytest.mark.parametrize("case", FILE_CASES, ids=[c[1] for c in FILE_CASES])
def test_specs_and_files_cross_the_packages(tmp_path, case):
    _, name, args, _ = case
    jm, tm = _pair(name, args)
    check_spec_and_files(jm, tm, str(tmp_path))
