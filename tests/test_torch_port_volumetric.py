"""``bigdl_tpu/nn/volumetric.py``'s 7 classes in the port, on the CPU.

Forward, input gradient and parameter gradients against ``jax.vjp`` of
the JAX layer within 1e-5 of the largest |JAX value|, on the same
random parameters: the 3-D conv with symmetric and SAME padding, the
transposed conv with ``adj`` below and above the stride (torch's own
output padding cannot reach the latter), both pools in floor and ceil
mode with padding and ``count_include_pad`` off, BN in training mode
(running statistics too) and eval mode, ``UpSampling3D`` and
``Cropping3D``; each class's spec and files across the packages.
"""

import numpy as np
import pytest

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom

from torch_port_parity import (assert_trees_equal, carry, check_module,
                               check_spec_and_files, randomize_params,
                               to_np)


def _n(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = [
    ("conv", "VolumetricConvolution", (2, 3, 2, 3, 2),
     lambda: _n(2, 2, 4, 5, 6)),
    ("conv-strided-pad", "VolumetricConvolution",
     (2, 3, 3, 2, 3, 2, 1, 2, 1, 0, 1), lambda: _n(2, 2, 6, 7, 5)),
    ("conv-same", "VolumetricConvolution",
     (2, 2, 2, 3, 2, 2, 2, 1, -1, -1, -1), lambda: _n(1, 2, 5, 6, 7)),
    ("conv-unbatched", "VolumetricConvolution", (2, 3, 2, 2, 2),
     lambda: _n(2, 3, 4, 4)),
    ("full", "VolumetricFullConvolution", (3, 2, 2, 3, 2, 2, 1, 2),
     lambda: _n(2, 3, 3, 4, 3)),
    ("full-pad-adj", "VolumetricFullConvolution",
     (2, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 1, 1, 0), lambda: _n(1, 2, 3, 4, 5)),
    ("full-adj-past-stride", "VolumetricFullConvolution",
     (2, 2, 2, 2, 3, 1, 1, 2, 0, 0, 1, 2, 1, 0), lambda: _n(1, 2, 3, 3, 3)),
    ("max", "VolumetricMaxPooling", (2,), lambda: _n(2, 2, 4, 6, 5)),
    ("max-ceil-pad", "VolumetricMaxPooling",
     (3, 3, 2, 2, 2, 1, 1, 1, 0, True), lambda: _n(1, 2, 7, 6, 5)),
    ("avg", "VolumetricAveragePooling", (2, 3, 2, 2, 1, 2),
     lambda: _n(2, 2, 5, 6, 7)),
    ("avg-pad-nocount", "VolumetricAveragePooling",
     (3, 3, 3, 2, 2, 2, 1, 1, 1, False, True), lambda: _n(1, 2, 6, 7, 5)),
    ("bn", "VolumetricBatchNormalization", (3,),
     lambda: _n(4, 3, 2, 3, 4)),
    ("up3d", "UpSampling3D", ((2, 1, 3),), lambda: _n(2, 2, 2, 3, 2)),
    ("crop3d", "Cropping3D", ((1, 0), (0, 2), (1, 1)),
     lambda: _n(2, 2, 4, 5, 6)),
]


def _pair(name, args, seed=3):
    JRandom.RNG.set_seed(seed)
    jm = getattr(JN, name)(*args)
    TRandom.RNG.set_seed(seed)
    tm = getattr(TN, name)(*args)
    return jm, tm


def test_cases_cover_every_class():
    from bigdl_tpu.nn import volumetric as JV

    assert {c[1] for c in CASES} == set(JV.__all__)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case, training):
    _, name, args, make = case
    jm, tm = _pair(name, args)
    for n, v in jm.params().items():
        if v is not None:
            np.testing.assert_array_equal(to_np(getattr(tm, n)),
                                          np.asarray(v))
    carry(jm, tm)
    if jm.params():
        randomize_params(jm, tm)
    if training:
        jm.training()
        tm.train()
    else:
        jm.evaluate()
        tm.evaluate()
    new_state = check_module(jm, tm, make(), training=training, jit=True)
    if not training:
        assert_trees_equal(tm.state(), new_state)
    # BN's running statistics after the training step
    for k, v in new_state.items():
        np.testing.assert_allclose(to_np(getattr(tm, k)), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)


FILE_CASES = list({c[1]: c for c in CASES}.values())


@pytest.mark.parametrize("case", FILE_CASES, ids=[c[1] for c in FILE_CASES])
def test_specs_and_files_cross_the_packages(tmp_path, case):
    _, name, args, _ = case
    jm, tm = _pair(name, args)
    check_spec_and_files(jm, tm, str(tmp_path))
