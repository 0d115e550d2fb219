"""AlexNet (``bigdl_tpu/models/alexnet.py``) in the port, on the CPU,
at full width: both builders draw JAX's weights from one seed (layer
names and the spec equal too), and 2 random 227 px images give JAX's
log-probabilities within 1e-5 of the largest |JAX value| in eval mode,
the grouped original (``n_group=2`` convs, cross-map LRN) included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import models as JM
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import models as TM
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T

from torch_port_parity import rel


@pytest.mark.parametrize("builder", ["build_alexnet",
                                     "build_alexnet_original"])
def test_alexnet_forward_matches_jax(builder):
    JRandom.RNG.set_seed(6)
    jm = getattr(JM, builder)(1000)
    TRandom.RNG.set_seed(6)
    tm = getattr(TM, builder)(1000)
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert TS.module_to_spec(tm) == JS.module_to_spec(jm)
    if builder == "build_alexnet_original":
        groups = [m.n_group for m in tm.modules
                  if type(m).__name__ == "SpatialConvolution"]
        assert groups == [1, 2, 1, 2, 2]
    x = np.random.RandomState(1).randn(2, 3, 227, 227).astype(np.float32)
    want = jm.evaluate().forward(jnp.asarray(x))
    with torch.no_grad():
        got = tm.evaluate()(torch.from_numpy(x))
    assert got.shape == (2, 1000)
    assert rel(got, want) <= 1e-5
