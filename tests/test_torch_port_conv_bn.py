"""bigdl_tpu_torch/ops/conv_bn.py against bigdl_tpu/ops/conv_bn.py.

The plain version of the fused conv + BN-statistics op (what the port's
wrapper runs on a CPU tensor, and what the CUDA kernels are held to on
the card) must match the JAX package's Pallas kernels run in interpret
mode, and the port's ``autograd.Function`` must give the gradients of
JAX's ``custom_vjp``.  Limits, as ``tests/test_fused.py``: y atol 1e-5;
s1/s2 rtol 1e-4, atol 1e-3 (sums over up to 2·15·15 f32 terms in
another order); gradients rtol 1e-4, atol 1e-4 (dshift atol 1e-3: it
carries n·gs1).  The kernels themselves are held to the plain version
on the card by ``chip_smoke.py``.  The bf16 kernels' arithmetic (the
kxk kernel's implicit GEMM over the NHWC, tap-major operands that
``kxk_operands`` builds; the 1x1 kernel's GEMM over NCHW x read in
place; both with statistics over pixel tiles flattened across samples)
is modelled in numpy and held to the same Pallas kernels and to the lax
reference at those limits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import conv_bn as JC
from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.ops import conv_bn as TC

Y_ATOL = 1e-5
S_RTOL, S_ATOL = 1e-4, 1e-3
G_RTOL, G_ATOL = 1e-4, 1e-4

# (n, c, h, w, o, k, stride, pad): ragged HW, O not a multiple of 8,
# stride 1 and 2, 1x1 / 3x3 / 5x5
CASES = [
    (2, 8, 7, 9, 13, 1, 1, 0),
    (2, 6, 10, 10, 16, 1, 2, 0),
    (3, 5, 9, 7, 11, 3, 1, 1),
    (2, 4, 9, 9, 10, 3, 2, 1),
    (2, 3, 8, 8, 6, 5, 1, 2),
]


def _case_id(c):
    return "n{}c{}_{}x{}_o{}_k{}s{}p{}".format(*c)


def _inputs(n, c, h, w, o, k, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c, h, w).astype(np.float32)
    wt = (rs.randn(o, c, k, k) * np.sqrt(2.0 / (c * k * k))).astype(
        np.float32)
    shift = (rs.randn(o) * 0.5).astype(np.float32)    # a non-zero shift
    return x, wt, shift


def _jax(x, w, shift, stride, pad):
    return JC.conv_bn_stats(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(shift), stride=stride, pad=pad,
                            interpret=True, impl="pallas")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_pallas_interpret(case):
    n, c, h, w, o, k, stride, pad = case
    x, wt, shift = _inputs(n, c, h, w, o, k, seed=sum(case))
    jy, js1, js2 = _jax(x, wt, shift, stride, pad)
    ty, ts1, ts2 = TC.conv_bn_stats(torch.from_numpy(x),
                                    torch.from_numpy(wt),
                                    torch.from_numpy(shift), stride=stride,
                                    pad=pad)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), rtol=S_RTOL,
                               atol=S_ATOL)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=S_RTOL,
                               atol=S_ATOL)


def test_1x1_weight_as_matrix():
    x, wt, shift = _inputs(2, 8, 6, 5, 12, 1, seed=4)
    full = TC.conv_bn_stats(torch.from_numpy(x), torch.from_numpy(wt),
                            torch.from_numpy(shift), stride=2)
    mat = TC.conv1x1_bn_stats(torch.from_numpy(x),
                              torch.from_numpy(wt[:, :, 0, 0]),
                              torch.from_numpy(shift), stride=2)
    for a, b in zip(full, mat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_backward_matches_jax_custom_vjp(case):
    n, c, h, w, o, k, stride, pad = case
    x, wt, shift = _inputs(n, c, h, w, o, k, seed=3 * sum(case))
    (jy, js1, js2), vjp = jax.vjp(
        lambda a, b, s: _jax(a, b, s, stride, pad), jnp.asarray(x),
        jnp.asarray(wt), jnp.asarray(shift))
    rs = np.random.RandomState(sum(case))
    gy = rs.randn(*jy.shape).astype(np.float32)
    gs1 = rs.randn(o).astype(np.float32)
    gs2 = (rs.randn(o) * 0.1).astype(np.float32)
    jdx, jdw, jds = vjp((jnp.asarray(gy), jnp.asarray(gs1),
                         jnp.asarray(gs2)))

    tx, tw, ts = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, wt, shift))
    out = TC.conv_bn_stats(tx, tw, ts, stride=stride, pad=pad)
    dx, dw, ds = torch.autograd.grad(
        out, (tx, tw, ts),
        (torch.from_numpy(gy), torch.from_numpy(gs1), torch.from_numpy(gs2)))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=G_RTOL,
                               atol=1e-3)


@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (1, 2, 0), (3, 1, 1),
                                          (3, 2, 1)])
def test_gradcheck_float64(k, stride, pad):
    rs = np.random.RandomState(k + stride)
    x = torch.from_numpy(rs.randn(2, 3, 5, 5)).requires_grad_(True)
    w = torch.from_numpy(rs.randn(4, 3, k, k)).requires_grad_(True)
    shift = torch.from_numpy(rs.randn(4)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b, s: TC.conv_bn_stats(a, b, s, stride=stride, pad=pad),
        (x, w, shift), eps=1e-6, atol=1e-5)


def test_cpu_tensor_runs_the_plain_version_and_launches_nothing():
    before = dict(_cuda.launches)
    x, wt, shift = _inputs(2, 4, 6, 6, 5, 3, seed=1)
    TC.conv_bn_stats(torch.from_numpy(x), torch.from_numpy(wt),
                     torch.from_numpy(shift), stride=1, pad=1)
    TC.conv_bn_stats(torch.from_numpy(x), torch.from_numpy(wt[:, :, :1, :1]),
                     torch.from_numpy(shift), stride=2)
    assert _cuda.launches == before


def test_cuda_wrapper_checks_before_any_launch():
    before = dict(_cuda.launches)
    x = torch.zeros(1, 4, 5, 5, dtype=torch.float64)
    w = torch.zeros(3, 4, 3, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TC._conv_bn_cuda(x, w, torch.zeros(3), 1, 1)
    with pytest.raises(ValueError, match="disagree"):
        TC._conv_bn_cuda(x.float(), w[:, :2].float(), torch.zeros(3), 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        TC.conv_bn_stats(x.to("meta"), w.to("meta"), torch.zeros(3,
                         device="meta"), stride=1, pad=1)
    assert _cuda.launches == before


# the bf16 kxk kernel's GEMM: (n, c, h, w, o, k, stride, pad): 3x3
# stride 1 and 2, C = 3 (zero-padded to 8), and a 7x7 image at N = 3,
# whose 147 output pixels make two flattened tiles, the first crossing
# from sample 0 through sample 2
KXK_GEMM_CASES = [
    (2, 16, 9, 9, 12, 3, 1, 1),
    (2, 16, 10, 10, 12, 3, 2, 1),
    (2, 3, 8, 8, 8, 3, 1, 1),
    (3, 8, 7, 7, 16, 3, 1, 1),
]


def _kxk_gemm_model(x, w, shift, stride, pad):
    """y, s1, s2 (numpy f32) as the bf16 kxk kernel forms them from the
    operands its layout pass writes (``kxk_operands``): M = O by
    N = N·Ho·Wo pixels
    flattened across samples, K tap-major over the padded channels,
    products summed in f32; each row's centred sums over a pixel tile of
    ``CONV_MMA_TILE_P`` taken as its four quarters of 32 (the four warps
    of a row) added in order, then the tiles' partial columns added in
    order (the fixed second pass)."""
    xh, wt = (t.numpy() for t in TC.kxk_operands(torch.from_numpy(x),
                                                 torch.from_numpy(w)))
    n, h, wd, cp = xh.shape
    o, k = wt.shape[:2]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    xp = np.pad(xh, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    # one B row per output pixel: its k·k taps' channel slices, in order
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride, :]
            for dy in range(k) for dx in range(k)]
    b = np.stack(taps, axis=3).reshape(n * ho * wo, k * k * cp)
    acc = wt.reshape(o, k * k * cp) @ b.T                   # (O, N·Ho·Wo)
    y = acc.reshape(o, n, ho, wo).transpose(1, 0, 2, 3)
    s1, s2 = _tile_stats(acc, shift)
    return y, s1, s2


def _tile_stats(acc, shift):
    """s1, s2 from the f32 accumulator (O, N·Ho·Wo) as the bf16 kernels'
    epilogue takes them: each row's centred sums over a pixel tile of
    ``CONV_MMA_TILE_P`` as its four quarters of 32 (the four warps of a
    row) added in order, then the tiles' partial columns in order."""
    o = acc.shape[0]
    tile = _cuda.CONV_MMA_TILE_P
    ncols = _cuda.conv_mma_tiles(acc.shape[1])
    d = acc - shift[:, None]
    part = np.zeros((2, o, ncols), np.float32)
    for j in range(ncols):
        seg = d[:, j * tile:(j + 1) * tile]
        for qn in range(4):
            quarter = seg[:, qn * tile // 4:(qn + 1) * tile // 4]
            part[0, :, j] += quarter.sum(1, dtype=np.float32)
            part[1, :, j] += (quarter * quarter).sum(1, dtype=np.float32)
    s1, s2 = np.zeros(o, np.float32), np.zeros(o, np.float32)
    for j in range(ncols):
        s1 += part[0, :, j]
        s2 += part[1, :, j]
    return s1, s2


def test_kxk_operands_are_tap_major_nhwc_with_zero_padded_channels():
    x, wt, _ = _inputs(2, 3, 5, 6, 4, 3, seed=8)
    xh, wh = TC.kxk_operands(torch.from_numpy(x), torch.from_numpy(wt))
    assert xh.shape == (2, 5, 6, 8) and wh.shape == (4, 3, 3, 8)
    assert xh.is_contiguous() and wh.is_contiguous()
    assert xh.data_ptr() % 16 == 0 and wh.data_ptr() % 16 == 0
    np.testing.assert_array_equal(xh[..., :3].numpy(),
                                  x.transpose(0, 2, 3, 1))
    assert not xh[..., 3:].abs().max() and not wh[..., 3:].abs().max()
    # the rows of the (O, k·k·Cp) GEMM operand in JAX's im2col order:
    # column t·Cp + c holds w[o, c, dy, dx] with t = dy·k + dx (_fwd_kxk)
    flat = wh.reshape(4, 9 * 8).numpy()
    for t in range(9):
        np.testing.assert_array_equal(flat[:, t * 8:t * 8 + 3],
                                      wt[:, :, t // 3, t % 3])
    # channels already a multiple of 8 are not padded
    x8, w8, _ = _inputs(1, 8, 4, 4, 2, 3, seed=9)
    assert TC.kxk_operands(torch.from_numpy(x8),
                           torch.from_numpy(w8))[0].shape == (1, 4, 4, 8)


@pytest.mark.parametrize("case", KXK_GEMM_CASES, ids=_case_id)
def test_kxk_gemm_model_matches_pallas_interpret_and_reference(case):
    """The bf16 kxk kernel's arithmetic, modelled on its operands, is
    JAX's function: the Pallas kernel in interpret mode and the lax
    ``_reference``.  Inputs hold bf16 values, so the products are exact
    in f32 and only the order of the f32 sums differs: y within 1e-5,
    s1/s2 within the module's limits."""
    n, c, h, w, o, k, stride, pad = case
    x, wt, shift = _inputs(n, c, h, w, o, k, seed=5 * sum(case))
    x, wt = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, wt))
    my, ms1, ms2 = _kxk_gemm_model(x, wt, shift, stride, pad)
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(shift))
    for jy, js1, js2 in (_jax(x, wt, shift, stride, pad),
                         JC._reference(*args, stride, pad)):
        assert my.shape == jy.shape
        np.testing.assert_allclose(my, np.asarray(jy), atol=Y_ATOL)
        np.testing.assert_allclose(ms1, np.asarray(js1), rtol=S_RTOL,
                                   atol=S_ATOL)
        np.testing.assert_allclose(ms2, np.asarray(js2), rtol=S_RTOL,
                                   atol=S_ATOL)
    # and the port's plain version, which the kernel is held to on the card
    _, ts1, ts2 = TC.conv_bn_stats_plain(*(torch.from_numpy(a) for a in
                                           (x, wt, shift)), stride, pad)
    np.testing.assert_allclose(ms1, ts1.numpy(), rtol=S_RTOL, atol=S_ATOL)
    np.testing.assert_allclose(ms2, ts2.numpy(), rtol=S_RTOL, atol=S_ATOL)


def test_kernel_path_names_a_kernel_for_every_shape():
    assert TC.kernel_path((2, 64, 56, 56), (256, 64)) == "cuda_1x1"
    assert TC.kernel_path((2, 64, 56, 56), (256, 64, 1, 1), stride=2) \
        == "cuda_1x1"
    for k, s in ((3, 1), (3, 2), (5, 1), (7, 2)):
        assert TC.kernel_path((2, 64, 56, 56), (64, 64, k, k), stride=s,
                              pad=(k - 1) // 2) == "cuda_kxk"
    # a bf16 1x1 whose C is not a multiple of 8 (the 1x1 kernel's 16-byte
    # weight rows) goes to the kxk kernel, whose layout pass pads C; in
    # f32 the 1x1 kernel takes any C
    assert TC.kernel_path((2, 20, 7, 7), (16, 20, 1, 1)) == "cuda_kxk"
    assert TC.kernel_path((2, 20, 7, 7), (16, 20, 1, 1), stride=2) \
        == "cuda_kxk"
    assert TC.kernel_path((2, 20, 7, 7), (16, 20), itemsize=4) == "cuda_1x1"
    assert TC.kernel_path((2, 24, 7, 7), (16, 24)) == "cuda_1x1"


def _mma_constant(name):
    """A tile constant of the bf16 conv_bn kernels (conv_bn_mma.cuh)."""
    import os
    import re

    text = open(os.path.join(_cuda.CSRC, "conv_bn_mma.cuh")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# the bf16 1x1 kernel's GEMM: (n, c, h, w, o, k, stride, pad): HW = 49 at
# N = 3 (147 flattened pixels: a tile that crosses from sample 0 into
# sample 2), HW = 196 with C = 136 (three k-steps: a run of CHAIN and a
# short one, the last k-step's channels past C zero) and O off the tile,
# and a strided site (14x14 -> 7x7)
GEMM_1X1_CASES = [
    (3, 16, 7, 7, 24, 1, 1, 0),
    (2, 136, 14, 14, 12, 1, 1, 0),
    (2, 24, 14, 14, 40, 1, 2, 0),
]


def _1x1_gemm_model(x, w, shift, stride):
    """y, s1, s2 (numpy f32) as the bf16 1x1 kernel forms them from NCHW
    x read in place: M = O by N = N·Ho·Wo output pixels flattened across
    samples (x[n, c, s·oy, s·ox]), K = C in k-steps of TK channels, the
    products of each run of CHAIN k-steps summed into a fresh f32 sum
    that is then added into the running one, statistics as the
    epilogue's tiles take them."""
    xs = x[:, :, ::stride, ::stride]
    n, c, ho, wo = xs.shape
    o = w.shape[0]
    b = xs.transpose(1, 0, 2, 3).reshape(c, n * ho * wo)     # (K, pixels)
    wt = w.reshape(o, c)
    run = _mma_constant("TK") * _mma_constant("CHAIN")
    acc = np.zeros((o, n * ho * wo), np.float32)
    for k0 in range(0, c, run):
        acc += wt[:, k0:k0 + run] @ b[k0:k0 + run]
    y = acc.reshape(o, n, ho, wo).transpose(1, 0, 2, 3)
    s1, s2 = _tile_stats(acc, shift)
    return y, s1, s2


@pytest.mark.parametrize("case", GEMM_1X1_CASES, ids=_case_id)
def test_1x1_gemm_model_matches_pallas_interpret_and_reference(case):
    """The bf16 1x1 kernel's arithmetic, modelled on NCHW x, is JAX's
    function: ``_fwd_kernel_1x1`` in interpret mode and the lax
    ``_reference``, at the module's limits (bf16 inputs: the products
    are exact in f32, only the order of the f32 sums differs)."""
    n, c, h, w, o, k, stride, pad = case
    assert c % 8 == 0 and TC.kernel_path((n, c, h, w), (o, c)) == "cuda_1x1"
    x, wt, shift = _inputs(n, c, h, w, o, k, seed=7 * sum(case))
    x, wt = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, wt))
    my, ms1, ms2 = _1x1_gemm_model(x, wt, shift, stride)
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(shift))
    for jy, js1, js2 in (_jax(x, wt, shift, stride, pad),
                         JC._reference(*args, stride, pad)):
        assert my.shape == jy.shape
        np.testing.assert_allclose(my, np.asarray(jy), atol=Y_ATOL)
        np.testing.assert_allclose(ms1, np.asarray(js1), rtol=S_RTOL,
                                   atol=S_ATOL)
        np.testing.assert_allclose(ms2, np.asarray(js2), rtol=S_RTOL,
                                   atol=S_ATOL)
    _, ts1, ts2 = TC.conv_bn_stats_plain(*(torch.from_numpy(a) for a in
                                           (x, wt, shift)), stride, pad)
    np.testing.assert_allclose(ms1, ts1.numpy(), rtol=S_RTOL, atol=S_ATOL)
    np.testing.assert_allclose(ms2, ts2.numpy(), rtol=S_RTOL, atol=S_ATOL)

