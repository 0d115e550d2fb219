"""The port's Torch7 ``.t7`` codec against the JAX package's, on the CPU.

- ``save_t7`` writes the JAX package's bytes for the same values
  (numbers, strings, booleans, nil, nested and shared tables, tensors
  of every dtype, ``TorchObject`` trees), and each package reads the
  other's files.
- ``load_torch_module`` maps an ``nn.*`` tree (Linear, the two
  SpatialConvolutions, both BNs with running statistics, pooling,
  View/Reshape, Dropout and the activations) onto the port's layers on
  the device asked for; its forward equals the JAX module's within
  1e-5 of the largest |JAX value|.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.utils import torch_file as JF
from bigdl_tpu_torch.utils import torch_file as TF

TOL = 1e-5


def _values(F):
    rs = np.random.RandomState(0)
    shared = {"v": 1, "w": rs.randn(2, 2).astype(np.float32)}
    return {
        "n": 3, "f": 2.5, "s": "hi", "t": True, "no": None,
        "list": [1, "a", 2.0], "x": shared, "y": shared,
        "f32": rs.randn(3, 4, 5).astype(np.float32),
        "f64": rs.randn(7).astype(np.float64),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "i32": np.arange(4, dtype=np.int32), "u8": np.arange(3, dtype=np.uint8),
        "obj": F.TorchObject("nn.Linear", {"weight": rs.randn(2, 3)
                                           .astype(np.float32)}),
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_t7_bytes_equal_and_each_reads_the_other(writer, tmp_path):
    jp, tp = str(tmp_path / "j.t7"), str(tmp_path / "t.t7")
    JF.save_t7(jp, _values(JF))
    TF.save_t7(tp, _values(TF))
    assert open(jp, "rb").read() == open(tp, "rb").read()
    path = jp if writer == "jax" else tp
    reader = TF if writer == "jax" else JF
    out = reader.load_t7(path)
    want = _values(JF)
    for k in ("n", "f", "s", "t", "list"):
        assert out[k] == want[k], k
    assert out["no"] is None and out["x"] is out["y"]
    for k in ("f32", "f64", "i64", "i32", "u8"):
        np.testing.assert_array_equal(out[k], want[k])
        assert out[k].dtype == want[k].dtype
    assert out["obj"].torch_type == "nn.Linear"
    assert type(out["obj"]).__module__ == reader.__name__


def test_torch_tensors_are_written_as_their_arrays(tmp_path):
    a = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    TF.save_t7(str(tmp_path / "a.t7"), torch.from_numpy(a))
    JF.save_t7(str(tmp_path / "b.t7"), a)
    assert (tmp_path / "a.t7").read_bytes() == (tmp_path / "b.t7").read_bytes()


def _tree(F, rs):
    def bn(cls, n):
        return F.TorchObject(cls, {
            "weight": rs.rand(n).astype(np.float32) + 0.5,
            "bias": rs.randn(n).astype(np.float32),
            "running_mean": rs.randn(n).astype(np.float32),
            "running_var": rs.rand(n).astype(np.float32) + 0.5,
            "eps": 1e-5})

    return F.TorchObject("nn.Sequential", {"modules": [
        F.TorchObject("nn.SpatialConvolutionMM", {
            "nInputPlane": 3, "nOutputPlane": 6, "kW": 3, "kH": 3,
            "dW": 1, "dH": 1, "padW": 1, "padH": 1,
            "weight": rs.randn(6, 27).astype(np.float32),
            "bias": rs.randn(6).astype(np.float32)}),
        bn("nn.SpatialBatchNormalization", 6),
        F.TorchObject("nn.ReLU", {}),
        F.TorchObject("nn.SpatialMaxPooling", {"kW": 2, "kH": 2, "dW": 2,
                                               "dH": 2}),
        F.TorchObject("nn.SpatialConvolution", {
            "nInputPlane": 6, "nOutputPlane": 4, "kW": 1, "kH": 1,
            "weight": rs.randn(4, 6, 1, 1).astype(np.float32),
            "bias": rs.randn(4).astype(np.float32)}),
        F.TorchObject("nn.SpatialAveragePooling", {"kW": 2, "kH": 2,
                                                   "dW": 2, "dH": 2}),
        F.TorchObject("nn.View", {"size": np.asarray([16])}),
        F.TorchObject("nn.Dropout", {"p": 0.3}),
        F.TorchObject("nn.Linear", {
            "weight": rs.randn(8, 16).astype(np.float32),
            "bias": rs.randn(8).astype(np.float32)}),
        bn("nn.BatchNormalization", 8),
        F.TorchObject("nn.Tanh", {}), F.TorchObject("nn.ELU", {}),
        F.TorchObject("nn.Reshape", {"size": np.asarray([8])}),
        F.TorchObject("nn.Identity", {}),
        F.TorchObject("nn.LogSoftMax", {}),
    ]})


def test_load_torch_module_forward_equals_jax(tmp_path):
    path = str(tmp_path / "m.t7")
    TF.save_t7(path, _tree(TF, np.random.RandomState(2)))
    jm = JF.load_torch_module(path)
    tm = TF.load_torch_module(path, device="cpu")
    assert {p.device.type for p in tm.parameters()} == {"cpu"}
    assert [type(m).__name__ for m in tm.modules] == \
        [type(m).__name__ for m in jm.modules]
    jm.evaluate()
    tm.evaluate()
    x = np.random.RandomState(3).randn(4, 3, 8, 8).astype(np.float32)
    want = np.asarray(jm.forward(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * max(np.max(np.abs(want)), 1)
    # the JAX module's loaded object tree loads the same in the port
    tm2 = TF.load_torch_module(JF.load_t7(path), device="cpu").evaluate()
    with torch.no_grad():
        np.testing.assert_array_equal(tm2(torch.from_numpy(x)).numpy(), got)


def test_load_torch_module_needs_the_card_unless_asked_for_the_cpu():
    obj = TF.TorchObject("nn.ReLU", {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.load_torch_module(obj)
    with pytest.raises(ValueError, match="unsupported"):
        TF.load_torch_module(TF.TorchObject("nn.Bogus", {}), device="cpu")
