"""Each operation and byte count against a count by hand at one shape."""

import os

import pytest

from benchmark import harness, roofline
from benchmark.reference import resnet


def test_bound_takes_the_larger_time():
    t, by = roofline.bound_s(3.35e12, 1e12, "bfloat16")
    assert (t, by) == (1.0, "bytes")
    t, by = roofline.bound_s(1.0, 989e12 * 2, "bfloat16")
    assert (t, by) == (2.0, "operations")


def test_taps_of_a_strided_1x1_read_every_other_row():
    assert roofline.taps(56, 1, 2, 0, 28) == 28
    assert roofline.taps(56, 3, 1, 1, 56) == 56
    assert roofline.taps(7, 7, 2, 3, 4) == 7


def test_conv_bn_by_hand():
    # 1x1/2: N=2, C=4, 8x8 -> O=6 at 4x4; bf16
    nbytes, flops = roofline.conv_bn(2, 4, 8, 8, 6, 1, 2, 2)
    x_read = 2 * 4 * 4 * 4                 # every other row and column
    assert nbytes == (x_read + 6 * 4 + 2 * 6 * 4 * 4) * 2 + 3 * 6 * 4
    assert flops == 2 * 2 * 6 * 4 * 4 * 4
    # 3x3/1 pad 1: the whole input is read
    nbytes, flops = roofline.conv_bn(1, 2, 5, 5, 3, 3, 1, 4)
    assert nbytes == (2 * 25 + 3 * 2 * 9 + 3 * 25) * 4 + 3 * 3 * 4
    assert flops == 2 * 3 * 2 * 9 * 25


def test_flash_kernels_by_hand():
    bh, t, d, item = 4, 8, 16, 2
    pairs = 8 * 9 / 2
    assert roofline.flash_fwd(bh, t, d, item) == (
        4 * bh * t * d * item + bh * t * 4, 4 * d * bh * pairs)
    assert roofline.flash_bwd_dq(bh, t, d, item) == (
        5 * bh * t * d * item + 2 * bh * t * 4, 6 * d * bh * pairs)
    assert roofline.flash_bwd_dkv(bh, t, d, item) == (
        6 * bh * t * d * item + 2 * bh * t * 4, 8 * d * bh * pairs)


def test_paged_decode_counts_the_live_positions():
    # 3 slots at lengths 0, 15, 16 (pages of 16): positions 1 + 16 + 17
    nbytes, flops = roofline.paged_decode(3, 2, 8, 34, 1 + 1 + 2, 2, 2)
    assert nbytes == 2 * 3 * 2 * 8 * 2 + 2 * 34 * 2 * 8 * 2 + 4 * 4 + 3 * 4
    assert flops == 4 * 2 * 8 * 34


def test_gpt2_medium_training_step():
    n = roofline.lm_matrix_params(1024, 24, 50257, 4)
    assert n == 24 * 12 * 1024 * 1024 + 1024 * 50257        # 353.5M
    step = roofline.lm_train_flops(1024, 24, 50257, 4, 16, 1024)
    assert step == pytest.approx(6 * n * 16384 + 6 * 1024 ** 3 * 24 * 16)
    assert 3.6e13 < step < 3.8e13


def test_serving_flops_by_hand():
    blocks = 2 * 12 * 8 * 8
    head = 8 * 10
    got = roofline.lm_serve_flops(8, 2, 10, 4, [3], 5, 20)
    assert got == 2 * (blocks * 3 + head) + 2 * 9 * 8 * 2 \
        + 2 * (blocks + head) * 5 + 4 * 8 * 2 * 20


def test_resnet50_forward_is_4_1_gmacs():
    cfg = harness.load_json(os.path.join(harness.BENCH, "configs",
                                         "resnet50.json"))
    convs = resnet.convs(cfg)
    assert sum(k == 1 for _, _, _, k, _, _ in convs) == 36
    assert sum(k == 3 for _, _, _, k, _, _ in convs) == 16
    assert resnet.forward_flops_per_sample(cfg) == pytest.approx(8.18e9,
                                                                 rel=0.01)
