"""The port's ``.bigdl`` protobuf interchange (``utils/bigdl_proto.py``)
against the JAX package's, on the CPU.

- An MLP, a conv/BN net, a ``Graph``, a recurrent net and a small
  ``TransformerLM``, built from one seed in both packages, saved as
  ``.bigdl`` by either package (``save_module``) and loaded by the
  other (``load_module``): the loaded model's eval output within 1e-5
  of the writer's on the same input, and its parameters equal to the
  writer's (f32 on the wire, so exactly).
- The hand-built Scala fixture of ``tests/test_bigdl_proto.py`` (a
  ``Sequential(Linear(3, 2))`` written byte by byte with the
  reference's attribute spellings) loads in the port.
- The running statistics of a trained BN survive a port file
  (bit-equal), and the JAX loader reads that file too.
- An unknown module type raises ``KeyError``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.models.transformer import build_transformer_lm as j_lm
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.models.transformer import build_transformer_lm as t_lm
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.bigdl_proto import ModuleLoader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_bigdl_proto import (_attr_bool, _attr_entry, _attr_int,  # noqa: E402
                              _bytes_field, _str_field, _tensor_msg,
                              _varint_field)

TOL = 1e-5


def _mlp(N):
    return N.Sequential().add(N.Linear(4, 8)).add(N.ReLU()) \
        .add(N.Linear(8, 2)).add(N.LogSoftMax())


def _convnet(N):
    return N.Sequential().add(N.SpatialConvolution(1, 4, 3, 3)) \
        .add(N.SpatialBatchNormalization(4)).add(N.ReLU()) \
        .add(N.SpatialMaxPooling(2, 2, 2, 2)) \
        .add(N.Reshape([4 * 3 * 3])).add(N.Linear(36, 2))


def _graph(N):
    inp = N.Input()
    a = N.Linear(4, 8)(inp)
    merged = N.CAddTable()(N.ReLU()(a), N.Tanh()(a))
    return N.Graph(inp, N.Linear(8, 2)(merged))


def _recurrent(N):
    return N.Sequential().add(N.Recurrent().add(N.LSTM(4, 6))) \
        .add(N.TimeDistributed(N.Linear(6, 3)))


def _lm(N):
    kw = dict(dim=16, n_head=2, n_layer=2, max_len=8)
    return t_lm(20, device="cpu", **kw) if N is TN else j_lm(20, **kw)


rs = np.random.RandomState(0)
CASES = {
    "mlp": (_mlp, rs.randn(3, 4).astype(np.float32)),
    "convnet": (_convnet, rs.randn(2, 1, 8, 8).astype(np.float32)),
    "graph": (_graph, rs.randn(3, 4).astype(np.float32)),
    "recurrent": (_recurrent, rs.randn(2, 5, 4).astype(np.float32)),
    "transformer_lm": (_lm, rs.randint(0, 20, (1, 6)).astype(np.int32)),
}


def _t_out(m, x):
    m.evaluate()
    with torch.no_grad():
        return m(torch.from_numpy(x)).numpy()


def _j_out(m, x):
    m.evaluate()
    return np.asarray(m.forward(jnp.asarray(x)))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_files_cross_load(tmp_path, case, writer):
    build, x = CASES[case]
    TRandom.RNG.set_seed(3)
    tm = build(TN)
    JRandom.RNG.set_seed(3)
    jm = build(JN)
    path = str(tmp_path / f"{case}.bigdl")
    if writer == "port":
        TS.save_module(tm, path)
        loaded, want = JS.load_module(path), _t_out(tm, x)
        got = _j_out(loaded, x)
        written = [v.detach().numpy() for v in T.leaves(tm.params())]
        read = [np.asarray(v) for v in jax.tree.leaves(loaded.params())]
    else:
        JS.save_module(jm, path)
        loaded, want = TS.load_module(path), _j_out(jm, x)
        got = _t_out(loaded, x)
        written = [np.asarray(v) for v in jax.tree.leaves(jm.params())]
        read = [v.detach().numpy() for v in T.leaves(loaded.params())]
    with open(path, "rb") as fh:
        assert fh.read(2) != b"PK"                   # protobuf, not npz
    assert type(loaded).__name__ == type(tm).__name__
    assert len(read) == len(written) > 0
    for a, b in zip(read, written):
        np.testing.assert_array_equal(a, b)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL, f"{case} written by {writer}: {err:.3e}"


def test_the_scala_fixture_loads(tmp_path):
    rs = np.random.RandomState(7)
    w = rs.randn(2, 3).astype(np.float32)
    b = rs.randn(2).astype(np.float32)
    linear = (_str_field(1, "fc1")
              + _str_field(7, "com.intel.analytics.bigdl.nn.Linear")
              + _str_field(9, "0.13.0")
              + _attr_entry("inputSize", _attr_int(3))
              + _attr_entry("outputSize", _attr_int(2))
              + _attr_entry("withBias", _attr_bool(True))
              + _bytes_field(3, _tensor_msg(w))
              + _bytes_field(4, _tensor_msg(b))
              + _varint_field(15, 1))
    seq = (_str_field(1, "seq")
           + _str_field(7, "com.intel.analytics.bigdl.nn.Sequential")
           + _str_field(9, "0.13.0") + _bytes_field(2, linear))
    path = tmp_path / "scala_fixture.bigdl"
    path.write_bytes(seq)
    model = ModuleLoader.load(str(path))
    assert type(model).__name__ == "Sequential" and model._name == "seq"
    fc = model.modules[0]
    assert type(fc).__name__ == "Linear" and fc._name == "fc1"
    x = rs.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(_t_out(model, x), x @ w.T + b, rtol=1e-5,
                               atol=1e-6)
    assert TS.load_module(str(path)).modules[0]._name == "fc1"


def test_bn_state_survives_a_port_file(tmp_path):
    TRandom.RNG.set_seed(3)
    m = _convnet(TN)
    m.train()
    with torch.no_grad():
        for _ in range(3):                      # move the running stats
            m(torch.from_numpy(CASES["convnet"][1] * 3 + 1))
    m.evaluate()
    path = TS.save_module(m, str(tmp_path / "bn.bigdl"))
    back = TS.load_module(path)
    assert not back.training
    for a, b in zip(T.leaves(back.state()), T.leaves(m.state())):
        assert torch.equal(a, b)
    x = CASES["convnet"][1]
    np.testing.assert_array_equal(_t_out(back, x), _t_out(m, x))
    # the JAX loader keeps only the attrs its constructors take
    j = JS.load_module(path)
    assert [np.asarray(v).shape for v in jax.tree.leaves(j.params())] == \
        [tuple(v.shape) for v in T.leaves(m.params())]


def test_an_unknown_type_raises(tmp_path):
    p = tmp_path / "bad.bigdl"
    p.write_bytes(_str_field(7, "com.intel.analytics.bigdl.nn.NoSuchLayer"))
    with pytest.raises(KeyError, match="NoSuchLayer"):
        ModuleLoader.load(str(p))
    with pytest.raises(KeyError, match="NoSuchLayer"):
        TS.load_module(str(p))
