"""The port's Caffe interop against the JAX package's, on the CPU.

- The prototxt text parser and printer give the same trees and text.
- ``tests/test_caffe.py``'s AlexNet-like prototxt (conv, LRN, pool,
  BatchNorm + Scale, InnerProduct, Softmax), its V1 legacy text and a
  net of the loader's other layer types build the same graph in both
  loaders, from the text alone (forwards within 1e-5) and with a
  caffemodel written by either package's wire writer (V1 layers for
  the V1 net): ``load_caffemodel`` reads bit-equal blobs in both
  packages, the loaded weights are bit-equal and the forwards agree
  within 1e-6 of the largest |value|.
- Files written by each package's ``CaffePersister`` (an AlexNet-like
  graph and one of the persister's other layer types) load in both
  loaders: bit-equal blobs, forwards within 1e-6 of the source's.
- ``load_caffe_weights`` and the loader's device rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.utils import caffe as JC
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.utils import caffe as TC
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

# forwards of the nets loaded from files, relative to the largest
# |value|; the text-only nets run on the initializers' weights, whose
# larger logits carry the two packages' f32 sums (in other orders) to
# 1.2e-6, so they are held to the port's layer limit
TOL = 1e-6
TEXT_TOL = 1e-5

ALEXNETISH = """
name: "TestNet"
input: "data"
input_shape { dim: 1 dim: 3 dim: 32 dim: 32 }
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 stride: 1 pad: 1 }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "relu1" }
layer {
  name: "norm1" type: "LRN" bottom: "relu1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 }
}
layer {
  name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1"
  batch_norm_param { eps: 0.001 }
}
layer {
  name: "scale1" type: "Scale" bottom: "bn1" top: "scale1"
  scale_param { bias_term: true }
}
layer {
  name: "fc" type: "InnerProduct" bottom: "scale1" top: "fc"
  inner_product_param { num_output: 10 }
}
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""

V1_LEGACY = """
name: "V1Net"
input: "data"
input_dim: 1 input_dim: 2 input_dim: 6 input_dim: 6
layers { name: "c" type: CONVOLUTION bottom: "data" top: "c"
  convolution_param { num_output: 3 kernel_size: 3 } }
layers { name: "r" type: RELU bottom: "c" top: "r" }
layers { name: "s" type: SOFTMAX bottom: "r" top: "s" }
"""

# the loader's other layer types, with two Eltwise fan-ins, a Concat,
# a dilated conv, a Deconvolution and an average pool in Caffe's ceil
# mode at an odd size
BRANCHY = """
name: "Branchy"
input: "data"
input_shape { dim: 1 dim: 4 dim: 9 dim: 9 }
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "c2" type: "Convolution" bottom: "data" top: "c2"
  convolution_param { num_output: 4 kernel_size: 3 pad: 2 dilation: 2 } }
layer { name: "prelu" type: "PReLU" bottom: "c2" top: "c2p" }
layer { name: "prod" type: "Eltwise" bottom: "c1" bottom: "c2p" top: "prod"
  eltwise_param { operation: PROD } }
layer { name: "th1" type: "TanH" bottom: "c1" top: "e" }
layer { name: "max" type: "Eltwise" bottom: "prod" bottom: "e" top: "max"
  eltwise_param { operation: MAX } }
layer { name: "cat" type: "Concat" bottom: "max" bottom: "data" top: "cat"
  concat_param { axis: 1 } }
layer { name: "up" type: "Deconvolution" bottom: "cat" top: "up"
  convolution_param { num_output: 3 kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "abs" type: "AbsVal" bottom: "up" top: "a" }
layer { name: "pw" type: "Power" bottom: "a" top: "p"
  power_param { power: 2 scale: 0.5 shift: 1 } }
layer { name: "bnll" type: "BNLL" bottom: "p" top: "b" }
layer { name: "pool" type: "Pooling" bottom: "b" top: "pool"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "lrelu" type: "ReLU" bottom: "pool" top: "lr"
  relu_param { negative_slope: 0.1 } }
layer { name: "sc" type: "Scale" bottom: "lr" top: "sc" }
layer { name: "th" type: "TanH" bottom: "sc" top: "th" }
layer { name: "drop" type: "Dropout" bottom: "th" top: "th"
  dropout_param { dropout_ratio: 0.3 } }
layer { name: "flat" type: "Flatten" bottom: "th" top: "flat" }
layer { name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
  inner_product_param { num_output: 6 } }
layer { name: "sig" type: "Sigmoid" bottom: "fc" top: "sig" }
"""

NETS = {"alexnetish": (ALEXNETISH, (2, 3, 32, 32)),
        "v1_legacy": (V1_LEGACY, (2, 2, 6, 6)),
        "branchy": (BRANCHY, (2, 4, 9, 9))}

# each net's blobs by layer, in Caffe's layouts (a Deconvolution's
# weight is (in, out, kh, kw); a BatchNorm's third blob scales the
# first two by its inverse)
BLOB_SHAPES = {
    "alexnetish": {"conv1": [(8, 3, 3, 3), (8,)],
                   "bn1": [(8,), (8,), (1,)], "scale1": [(8,), (8,)],
                   "fc": [(10, 8 * 16 * 16), (10,)]},
    "v1_legacy": {"c": [(3, 2, 3, 3), (3,)]},
    "branchy": {"c1": [(4, 4, 1, 1), (4,)], "c2": [(4, 4, 3, 3), (4,)],
                "prelu": [(4,)], "up": [(8, 3, 3, 3), (3,)],
                "sc": [(3,), (3,)], "fc": [(6, 3 * 8 * 8), (6,)]},
}
# the V1 legacy net is written as V1 layers (field 2, type by enum)
V1_ENUMS = {"CONVOLUTION": 4}


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _blob(rs, shape):
    """A weight scaled by its fan-in; a vector (bias, BN statistics,
    BN's scale factor, Scale, PReLU) in [0.5, 1.5)."""
    if len(shape) == 1:
        return rs.uniform(0.5, 1.5, shape).astype(np.float32)
    return (rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(
        np.float32)


def _blobs(net):
    rs = np.random.RandomState(8)
    return {name: [_blob(rs, s) for s in shapes]
            for name, shapes in BLOB_SHAPES[net].items()}


def _write_caffemodel(C, path, net):
    """``net``'s blobs as a caffemodel, by package ``C``'s wire writer."""
    text = NETS[net][0]
    types = {ly["name"][0]: ly["type"][0]
             for ly in C.parse_prototxt(text).get("layer", [])
             + C.parse_prototxt(text).get("layers", [])}
    out = C._WireWriter()
    out.string(1, C.parse_prototxt(text)["name"][0])
    for name, arrs in _blobs(net).items():
        lp = C._WireWriter()
        if net == "v1_legacy":
            lp.string(4, name)
            lp.varint(5, V1_ENUMS[types[name]])
            for a in arrs:
                lp.message(6, C._array_to_blob(a))
            out.message(2, lp)
        else:
            lp.string(1, name)
            lp.string(2, types[name])
            for a in arrs:
                lp.message(7, C._array_to_blob(a))
            out.message(100, lp)
    with open(path, "wb") as f:
        f.write(out.tobytes())


def _assert_blobs_equal(a, b):
    assert list(a) == list(b)
    for name in a:
        assert a[name]["type"] == b[name]["type"]
        assert len(a[name]["blobs"]) == len(b[name]["blobs"])
        for x, y in zip(a[name]["blobs"], b[name]["blobs"]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_prototxt_text_matches_jax():
    for text, _ in NETS.values():
        tree = TC.parse_prototxt(text)
        assert tree == JC.parse_prototxt(text)
        assert TC.format_prototxt(tree) == JC.format_prototxt(tree)
        assert TC.parse_prototxt(TC.format_prototxt(tree)) == tree


@pytest.mark.parametrize("net", sorted(NETS))
def test_text_only_nets_load_alike(net):
    """A prototxt alone: both loaders build the same graph (same leaf
    paths; the JAX weights carried over give the same forward)."""
    text, shape = NETS[net]
    JRandom.RNG.set_seed(3)
    jg = JC.CaffeLoader(prototxt_text=text).load().evaluate()
    tg = TC.CaffeLoader(prototxt_text=text, device="cpu").load().evaluate()
    assert [n for n, _ in T.leaves_with_paths(tg.params())] == \
        [n for n, _ in T.leaves_with_paths(jg.params())]
    load_jax_params(tg, jax.tree.map(np.asarray, jg.params()))
    load_jax_state(tg, jax.tree.map(np.asarray, jg.state()))
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    assert _rel(tg(torch.from_numpy(x)),
                jg.forward(jnp.asarray(x))) <= TEXT_TOL


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_caffemodels_load_alike(tmp_path, net, writer):
    """A caffemodel written by either package's wire writer: the same
    blobs in both readers, and the same weights and forward in both
    loaders (Deconvolution, PReLU, BatchNorm + Scale and V1 layers
    included)."""
    text, shape = NETS[net]
    model = str(tmp_path / "n.caffemodel")
    _write_caffemodel(JC if writer == "jax" else TC, model, net)
    blobs = TC.load_caffemodel(model)
    _assert_blobs_equal(blobs, JC.load_caffemodel(model))
    for name, arrs in _blobs(net).items():
        for a, b in zip(blobs[name]["blobs"], arrs):
            np.testing.assert_array_equal(a.reshape(b.shape), b)
    tg = TC.CaffeLoader(prototxt_text=text, model_path=model,
                        device="cpu").load().evaluate()
    jg = JC.CaffeLoader(prototxt_text=text, model_path=model).load()
    jg.evaluate()
    for a, b in zip(T.leaves_with_paths(tg.params()),
                    T.leaves_with_paths(jg.params())):
        assert a[0] == b[0]
        np.testing.assert_array_equal(_np(a[1]), _np(b[1]))
    for a, b in zip(T.leaves(tg.state()), T.leaves(jg.state())):
        np.testing.assert_array_equal(_np(a), _np(b))
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    assert _rel(tg(torch.from_numpy(x)), jg.forward(jnp.asarray(x))) <= TOL


def _alexnetish_graph(N):
    """ALEXNETISH as a graph built by hand (Caffe's flatten made
    explicit, so the persister can write it)."""
    inp = N.Input("data")
    x = N.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1).set_name("conv1")(inp)
    x = N.ReLU().set_name("relu1")(x)
    x = N.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1")(x)
    x = N.SpatialMaxPooling(2, 2, 2, 2).set_name("pool1")(x)
    x = N.SpatialBatchNormalization(8, eps=0.001).set_name("bn1")(x)
    x = N.Reshape([8 * 16 * 16]).set_name("flat")(x)
    x = N.Linear(8 * 16 * 16, 10).set_name("fc")(x)
    return N.Graph(inp, N.SoftMax().set_name("prob")(x))


def _branchy_graph(N):
    """The persister's other layer types: a dilated conv, Eltwise
    PROD/MAX/SUM, a leaky ReLU, a Concat, pools in ceil mode at odd
    sizes, Dropout, a Reshape that is not a flatten, LogSoftMax."""
    inp = N.Input("data")
    c1 = N.SpatialConvolution(4, 4, 1, 1).set_name("c1")(inp)
    c2 = N.SpatialDilatedConvolution(4, 4, 3, 3, 1, 1, 2, 2, 2, 2)(inp)
    prod = N.CMulTable()(c1, c2)
    mx = N.CMaxTable()(prod, N.LeakyReLU(0.1)(c1))
    cat = N.JoinTable(2)(N.CAddTable()(mx, c1), inp)
    x = N.SpatialAveragePooling(3, 3, 2, 2).ceil()(cat)
    x = N.SpatialMaxPooling(3, 3, 2, 2, 1, 1).ceil()(x)
    x = N.Dropout(0.3)(N.Tanh()(x))
    x = N.Reshape([8, 9])(x)
    x = N.Sigmoid()(N.Reshape([72])(x))
    return N.Graph(inp, N.LogSoftMax()(N.Linear(72, 6).set_name("fc")(x)))


GRAPHS = {"alexnetish": (_alexnetish_graph, (2, 3, 32, 32)),
          "branchy": (_branchy_graph, (2, 4, 9, 9))}


def _graph_pair(which):
    """The same hand-built graph in both packages, the BN statistics
    and affine off their initial values."""
    build, shape = GRAPHS[which]
    JRandom.RNG.set_seed(3)
    jg = build(JN)
    rs = np.random.RandomState(8)
    for m in jg.modules:
        if type(m).__name__ == "SpatialBatchNormalization":
            m.running_mean = jnp.asarray(rs.uniform(-1, 1, 8).astype(
                np.float32))
            m.running_var = jnp.asarray(rs.uniform(0.5, 1.5, 8).astype(
                np.float32))
            m.weight = jnp.asarray(rs.uniform(0.5, 1.5, 8).astype(
                np.float32))
    tg = build(TN)
    load_jax_params(tg, jax.tree.map(np.asarray, jg.params()))
    load_jax_state(tg, jax.tree.map(np.asarray, jg.state()))
    return jg.evaluate(), tg.evaluate(), shape


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("which", sorted(GRAPHS))
def test_persister_files_load_across_packages(tmp_path, which, writer):
    jg, tg, shape = _graph_pair(which)
    proto, model = str(tmp_path / "n.prototxt"), str(tmp_path / "n.caffemodel")
    C, src = (JC, jg) if writer == "jax" else (TC, tg)
    C.CaffePersister.save(src, proto, model, input_shape=shape[1:])
    _assert_blobs_equal(TC.load_caffemodel(model), JC.load_caffemodel(model))
    t_loaded = TC.CaffeLoader(proto, model, device="cpu").load().evaluate()
    j_loaded = JC.CaffeLoader(proto, model).load().evaluate()
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = jg.forward(jnp.asarray(x))
    if isinstance(jg.output_nodes[0].module, JN.LogSoftMax):
        want = jnp.exp(want)       # Caffe has no LogSoftmax: Softmax
    assert _rel(t_loaded(torch.from_numpy(x)), want) <= TOL
    assert _rel(j_loaded.forward(jnp.asarray(x)), want) <= TOL
    for a, b in zip(T.leaves_with_paths(t_loaded.params()),
                    T.leaves_with_paths(j_loaded.params())):
        assert a[0] == b[0]
        np.testing.assert_array_equal(_np(a[1]), _np(b[1]))


def test_written_files_equal_the_jax_writers(tmp_path):
    """The same graph written by each persister: the same layers and
    bit-equal blobs."""
    jg, tg, shape = _graph_pair("alexnetish")
    JC.CaffePersister.save(jg, str(tmp_path / "j.prototxt"),
                           str(tmp_path / "j.caffemodel"), shape[1:])
    TC.CaffePersister.save(tg, str(tmp_path / "t.prototxt"),
                           str(tmp_path / "t.caffemodel"), shape[1:])
    _assert_blobs_equal(TC.load_caffemodel(str(tmp_path / "t.caffemodel")),
                        JC.load_caffemodel(str(tmp_path / "j.caffemodel")))
    t_txt = TC.parse_prototxt(open(tmp_path / "t.prototxt").read())
    j_txt = JC.parse_prototxt(open(tmp_path / "j.prototxt").read())
    for a, b in zip(t_txt["layer"], j_txt["layer"]):
        assert {k: v for k, v in a.items() if k not in ("bottom", "top")} \
            == {k: v for k, v in b.items() if k not in ("bottom", "top")}
def test_v2_elu_loads():
    """V2's "ELU" type is upper case, like a V1 enum: the port keeps it
    (the JAX loader raises on it)."""
    text = V1_LEGACY.replace("layers { name: \"r\" type: RELU",
                             "layers { name: \"r\" type: \"ELU\"")
    g = TC.CaffeLoader(prototxt_text=text, device="cpu").load()
    elu = [m for m in g.modules if isinstance(m, TN.ELU)]
    assert len(elu) == 1 and elu[0].alpha == 1.0
    with pytest.raises(JC.CaffeConversionException, match="Elu"):
        JC.CaffeLoader(prototxt_text=text).load()


def test_writer_splices_blob_views_and_joins_once():
    w = TC._WireWriter()
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    lp = TC._WireWriter()
    lp.message(7, TC._array_to_blob(arr))
    w.message(100, lp)
    views = [p for p in w.parts if isinstance(p, memoryview)]
    assert len(views) == 1 and views[0].obj is not None
    assert w.size == len(w.tobytes())
    blob = TC._w_msgs(TC._w_msgs(TC.parse_wire(w.tobytes()), 100)[0], 7)[0]
    np.testing.assert_array_equal(TC._blob_to_array(blob), arr)


def test_load_caffe_weights_by_name(tmp_path):
    TRandom.RNG.set_seed(1)
    inp = TN.Input("data")
    fc = TN.Linear(4, 3).set_name("ip")(inp)
    g = TN.Graph(inp, fc)
    TC.CaffePersister.save(g, str(tmp_path / "a.prototxt"),
                           str(tmp_path / "a.caffemodel"))
    inp2 = TN.Input("data")
    fc2 = TN.Linear(4, 3).set_name("ip")(inp2)
    g2 = TN.Graph(inp2, fc2)
    TC.load_caffe_weights(g2, str(tmp_path / "a.caffemodel"))
    x = torch.randn(2, 4)
    assert torch.equal(g2(x), g(x))
    g3 = TN.Graph(TN.Input("d"), TN.Linear(4, 3).set_name("other")(
        TN.Input("d")))
    with pytest.raises(TC.CaffeConversionException, match="no layers"):
        TC.load_caffe_weights(g3, str(tmp_path / "a.caffemodel"))


def test_loader_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.CaffeLoader(prototxt_text=V1_LEGACY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.load_caffe_model("unused.prototxt", "unused.caffemodel")
    g = TC.CaffeLoader(prototxt_text=V1_LEGACY, device="cpu").load()
    assert all(p.device.type == "cpu" for p in g.parameters())
