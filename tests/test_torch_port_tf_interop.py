"""The port's TensorFlow interop against the JAX package's, on the CPU.

- Every test of ``tests/test_tf_interop.py`` but the training session
  (the op families: MLP, conv, pooling, BN, the elementwise and
  reduction vocabulary, split/pack/slice/gather, constant folding,
  Dequantize, resize, while frames, the saver round trips) runs with
  its ``TensorflowLoader`` replaced by one that loads each graph in
  both packages: every forward of the JAX model is checked against the
  port's on the same inputs, within 1e-5 of the largest |JAX value|,
  and a graph JAX refuses the port refuses too.  The JAX test's own
  assertions then run on JAX's output.
- The TF conditionals of ``tests/test_control_ops.py`` the same way.
- ``GraphDef`` bytes equal from both savers for the same weights, and
  each loader's forward on the other's graph.
- Switch/Merge conditionals and a while frame: forward and input
  gradients against ``jax.grad``, both ways of the predicate.
- Pipeline extraction from a graph with its own TFRecord input side.
- ``TFTrainingSession`` losses over 3 steps, Local and Distri (the
  port at world 1, JAX over its test mesh of 8 virtual devices, so
  within 2e-4), on the JAX session's weights.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as JN
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.utils import tf_interop as JTF
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.utils import tf_interop as TTF
from bigdl_tpu_torch.utils.convert import load_jax_params

TOL = 1e-5


def _jax_test_module(name):
    """``tests/<name>.py``, the JAX package's test file, loaded as a
    module of its own (its functions are called here, not collected)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name(name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JC = _jax_test_module("test_control_ops")
JT = _jax_test_module("test_tf_interop")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _to_torch(x):
    if isinstance(x, (tuple, list)):
        return tuple(_to_torch(v) for v in x)
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g).astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (g.shape, w.shape)
        # the non-finite values agree exactly, the finite ones closely
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        inf = np.isinf(w)
        np.testing.assert_array_equal(g[inf], w[inf])
        fin = np.isfinite(w)
        g, w = g[fin], w[fin]
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1.0)
        err = float(np.max(np.abs(g - w))) if w.size else 0.0
        assert err <= tol * scale, (err, scale)


_JLoader = JTF.TensorflowLoader


class _DualLoader:
    """JAX's ``TensorflowLoader`` that also loads each graph with the
    port's loader: the JAX model it returns checks every forward
    against the port model's."""

    checks = 0

    def __init__(self, path=None, data=None):
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        self.j = _JLoader(data=data)
        self.t = TTF.TensorflowLoader(data=data, device="cpu")

    def __getattr__(self, name):
        return getattr(self.j, name)

    def load(self, *args, **kwargs):
        try:
            jm = self.j.load(*args, **kwargs)
        except JTF.TFConversionException:
            with pytest.raises(TTF.TFConversionException):
                self.t.load(*args, **kwargs)
            raise
        tm = self.t.load(*args, **kwargs)
        assert type(tm).__name__ == type(jm).__name__
        j_forward, j_evaluate = jm.forward, jm.evaluate

        def forward(x, *a, **kw):
            y = j_forward(x, *a, **kw)
            with torch.no_grad():
                _close(tm(_to_torch(x)), y)
            _DualLoader.checks += 1
            return y

        def evaluate():
            tm.evaluate()
            return j_evaluate()

        jm.forward, jm.evaluate = forward, evaluate
        return jm


JAX_TESTS = sorted(
    name for name, fn in vars(JT).items()
    if name.startswith("test_") and callable(fn)
    and name != "test_tf_training_session_finetunes_under_distri_optimizer")


def test_every_jax_tf_test_is_mirrored():
    assert len(JAX_TESTS) == 37


@pytest.mark.parametrize("name", JAX_TESTS)
def test_jax_tf_test_holds_on_the_port(name, monkeypatch, tmp_path):
    monkeypatch.setattr(JT, "TensorflowLoader", _DualLoader)
    fn = getattr(JT, name)
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    before = _DualLoader.checks
    fn(**kw)
    if name not in ("test_parse_graphdef",
                    "test_minimum_with_const_and_cast_to_int_rejected",
                    "test_strided_slice_batch_cut_rejected"):
        assert _DualLoader.checks > before, "no forward was compared"


CONTROL_TESTS = sorted(n for n in vars(JC.TestTFControlFlowImport)
                       if n.startswith("test_"))


@pytest.mark.parametrize("name", CONTROL_TESTS)
def test_jax_control_flow_import_test_holds_on_the_port(name, monkeypatch):
    """``tests/test_control_ops.py``'s TF conditionals (a Switch/Merge,
    a nested cond, a Merge with its inputs swapped)."""
    assert len(CONTROL_TESTS) == 3
    monkeypatch.setattr(JTF, "TensorflowLoader", _DualLoader)
    before = _DualLoader.checks
    getattr(JC.TestTFControlFlowImport(), name)()
    assert _DualLoader.checks > before


def test_parse_graphdef_agrees():
    data, _ = JT._mlp_graphdef()
    j, t = JTF.parse_graphdef(data), TTF.parse_graphdef(data)
    assert [(n.name, n.op, n.inputs, sorted(n.attrs)) for n in j] == \
        [(n.name, n.op, n.inputs, sorted(n.attrs)) for n in t]


# ---- the savers ----------------------------------------------------------------
def _cnn(N):
    inp = N.Input("img")
    h = N.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1).set_name("c1")(inp)
    h = N.SpatialBatchNormalization(6).set_name("bn1")(h)
    h = N.ReLU().set_name("r1")(h)
    h = N.SpatialMaxPooling(2, 2, 2, 2).set_name("p1")(h)
    a = N.SpatialConvolution(6, 4, 1, 1).set_name("ca")(h)
    b = N.SpatialConvolution(6, 4, 3, 3, 1, 1, 1, 1).set_name("cb")(h)
    h = N.JoinTable(2).set_name("cat")(a, b)
    h = N.SpatialAveragePooling(2, 2, 2, 2).set_name("p2")(h)
    h = N.Reshape([8 * 2 * 2]).set_name("flat")(h)
    h = N.Linear(32, 10).set_name("fc")(h)
    h = N.Dropout(0.5).set_name("drop")(h)
    h = N.LogSoftMax().set_name("logp")(h)
    return N.Graph(inp, h)


def _pair():
    JRandom.RNG.set_seed(21)
    jg = _cnn(JN)
    TRandom.RNG.set_seed(21)
    tg = _cnn(TN)
    load_jax_params(tg, jax.tree.map(np.asarray, jg.params()))
    # non-trivial running statistics, equal in both
    rs = np.random.RandomState(3)
    mean = rs.randn(6).astype(np.float32)
    var = (rs.rand(6) + 0.5).astype(np.float32)
    bn_j = jg.find_module("bn1")
    bn_j.running_mean, bn_j.running_var = jnp.asarray(mean), \
        jnp.asarray(var)
    tg.find_module("bn1").set_state({"running_mean": torch.from_numpy(mean),
                                     "running_var": torch.from_numpy(var)})
    jg.evaluate()
    tg.evaluate()
    return jg, tg


def test_savers_write_equal_bytes(tmp_path):
    jg, tg = _pair()
    jb = JTF.TensorflowSaver.to_graphdef(jg)
    tb = TTF.TensorflowSaver.to_graphdef(tg)
    assert jb == tb
    TTF.TensorflowSaver.save(tg, str(tmp_path / "t.pb"))
    assert (tmp_path / "t.pb").read_bytes() == jb


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_loader_reads_the_others_graph(writer, tmp_path):
    jg, tg = _pair()
    path = str(tmp_path / "g.pb")
    (JTF if writer == "jax" else TTF).TensorflowSaver.save(
        jg if writer == "jax" else tg, path)
    jl = JTF.TensorflowLoader(path).load()
    tl = TTF.TensorflowLoader(path, device="cpu").load()
    jl.evaluate()
    tl.evaluate()
    x = np.random.RandomState(5).randn(2, 3, 8, 8).astype(np.float32)
    want = np.asarray(jg.forward(jnp.asarray(x)))
    with torch.no_grad():
        _close(tl(torch.from_numpy(x)), want)
    _close(np.asarray(jl.forward(jnp.asarray(x))), want)


def test_loader_builds_on_the_device_it_is_given():
    data, _ = JT._mlp_graphdef()
    m = TTF.TensorflowLoader(data=data, device="cpu").load()
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert all(p.dtype == torch.float32 for p in m.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTF.TensorflowLoader(data=data)
        with pytest.raises(RuntimeError, match="CUDA"):
            TTF.TFTrainingSession(data=data, inputs=["x"], outputs=["prob"])


# ---- control flow ----------------------------------------------------------------
def _cond_graph():
    b = JTF.GraphDefBuilder()
    b.placeholder("x")
    b.placeholder("p")
    b.const("w", np.random.RandomState(0).randn(3, 3).astype(np.float32))
    b.op("sw", "Switch", ["x", "p"])
    b.op("neg", "Neg", ["sw"])
    b.op("mm", "MatMul", ["sw:1", "w"])
    b.op("tanh", "Tanh", ["mm"])
    b.op("out", "Merge", ["tanh", "neg"])
    return b.tobytes(), ["x", "p"], ["out"]


def _while_graph():
    b = JTF.GraphDefBuilder()
    b.placeholder("x")
    b.placeholder("cnt")
    b.op("enter_x", "Enter", ["x"])
    b.op("enter_c", "Enter", ["cnt"])
    b.op("merge_x", "Merge", ["enter_x", "next_x"])
    b.op("merge_c", "Merge", ["enter_c", "next_c"])
    b.const("four", np.asarray(4.0, np.float32))
    b.op("less", "Less", ["merge_c", "four"])
    b.op("cond", "LoopCond", ["less"])
    b.op("switch_x", "Switch", ["merge_x", "cond"])
    b.op("switch_c", "Switch", ["merge_c", "cond"])
    b.const("w", (np.random.RandomState(1).randn(3, 3) * 0.5)
            .astype(np.float32))
    b.const("one", np.asarray(1.0, np.float32))
    b.op("mm", "MatMul", ["switch_x:1", "w"])
    b.op("body_x", "Tanh", ["mm"])
    b.op("body_c", "Add", ["switch_c:1", "one"])
    b.op("next_x", "NextIteration", ["body_x"])
    b.op("next_c", "NextIteration", ["body_c"])
    b.op("exit_x", "Exit", ["switch_x"])
    return b.tobytes(), ["x", "cnt"], ["exit_x"]


CASES = {
    # (graph, the second input's values): the predicate both ways, and
    # the while loop's start count for 4, 1 and 0 (cap-free) trips
    "cond": (_cond_graph, [True, False]),
    "while": (_while_graph, [0.0, 3.0, 7.0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_graphs_forward_and_gradient(case):
    build, seconds = CASES[case]
    data, ins, outs = build()
    jm = JTF.TensorflowLoader(data=data).load(ins, outs)
    tm = TTF.TensorflowLoader(data=data, device="cpu").load(ins, outs)
    assert type(tm).__name__ == type(jm).__name__ == (
        "DynamicGraph" if case == "while" else "Graph")
    x = np.random.RandomState(7).randn(2, 3).astype(np.float32)
    for s in seconds:
        second = np.asarray(s, np.bool_ if case == "cond" else np.float32)

        def f(xx):
            return jnp.sum(jnp.sin(jm.forward((xx, jnp.asarray(second)))))

        want, gx = jax.value_and_grad(f)(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = torch.sum(torch.sin(tm((xt, torch.from_numpy(second)))))
        got.backward()
        _close(got, want)
        _close(xt.grad, gx)


# ---- the input pipeline -----------------------------------------------------------
def _pipeline_files(tmp_path):
    from bigdl_tpu_torch.examples.train_from_tf_pipeline import (
        export_pipeline_graph, write_tfrecords)

    rs = np.random.RandomState(11)
    x = rs.randn(48, 16).astype(np.float32)
    y = (rs.randint(0, 4, 48) + 1).astype(np.float32)
    files = write_tfrecords(str(tmp_path), x, y)
    pb = export_pipeline_graph(str(tmp_path / "g.pb"), files, 16, 4,
                               batch=16)
    return pb, files, x, y


def test_pipeline_extraction_agrees(tmp_path):
    pb, files, x, y = _pipeline_files(tmp_path)
    jl = JTF.TensorflowLoader(pb)
    tl = TTF.TensorflowLoader(pb, device="cpu")
    assert jl.has_input_pipeline() and tl.has_input_pipeline()
    jp, tp = jl.extract_input_pipeline(), tl.extract_input_pipeline()
    assert tp.seam_refs == jp.seam_refs == ["parse"]
    assert tp.seam_keys == jp.seam_keys
    assert tp.batch_size == jp.batch_size == 16
    assert tp.nodes == jp.nodes
    assert tp.dataset.filenames == jp.dataset.filenames == files
    assert tl.model_outputs(exclude=tp.nodes) == \
        jl.model_outputs(exclude=jp.nodes) == ["logp"]
    (tx,), ttab = tp.feature_table()
    (jx,), jtab = jp.feature_table()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(ttab["y"].reshape(-1), y)
    for (tb, _), (jb, _) in zip(tp.batches(), jp.batches()):
        np.testing.assert_array_equal(tb[0], jb[0])


# ---- the training session --------------------------------------------------------
def _mlp_bytes():
    rs = np.random.RandomState(8)
    b = JTF.GraphDefBuilder()
    b.placeholder("x")
    b.const("w1", rs.randn(16, 32).astype(np.float32) * 0.3)
    b.const("b1", np.zeros(32, np.float32))
    b.const("w2", rs.randn(32, 4).astype(np.float32) * 0.3)
    b.op("mm1", "MatMul", ["x", "w1"])
    b.op("h", "BiasAdd", ["mm1", "b1"])
    b.op("r", "Relu", ["h"])
    b.op("mm2", "MatMul", ["r", "w2"])
    b.op("logp", "LogSoftmax", ["mm2"])
    return b.tobytes()


class _Losses:
    """A train summary that keeps the "Loss" of every step."""

    def __init__(self):
        self.v = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.v.append(float(value))

    def get_summary_trigger(self, name):
        return None


def _recording(monkeypatch, cls, rec):
    """Every ``cls`` trainer reports its losses to ``rec``."""
    real = cls.optimize

    def optimize(self):
        self.set_train_summary(rec)
        return real(self)

    monkeypatch.setattr(cls, "optimize", optimize)


@pytest.mark.parametrize("distributed", [False, True])
def test_training_session_losses_equal_jax(distributed, monkeypatch):
    from bigdl_tpu import optim as JO
    from bigdl_tpu.dataset import ArrayDataSet as JArray
    from bigdl_tpu.engine import Engine as JEngine
    from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
    from bigdl_tpu_torch import optim as TO
    from bigdl_tpu_torch.dataset import ArrayDataSet as TArray
    from bigdl_tpu_torch.engine import Engine as TEngine
    from bigdl_tpu_torch.optim.distri_optimizer import \
        DistriOptimizer as TDistri

    rs = np.random.RandomState(4)
    x = rs.randn(96, 16).astype(np.float32)
    y = (rs.randint(0, 4, 96) + 1).astype(np.float32)
    data = _mlp_bytes()
    out = {}
    for pkg, TF, N, O, E, D, A in (
            ("jax", JTF, JN, JO, JEngine, JDistri, JArray),
            ("torch", TTF, TN, TO, TEngine, TDistri, TArray)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        sess = TF.TFTrainingSession(data=data, inputs=["x"],
                                    outputs=["logp"], **kw)
        before = _np(sess.run(x[:4]))
        rec = _Losses()
        _recording(monkeypatch, D if distributed else O.LocalOptimizer, rec)
        E.reset()
        if distributed:
            E.init(*([] if pkg == "jax" else ["cpu"]))
        try:
            sess.train(A(x, y, 32, shuffle=False), N.ClassNLLCriterion(),
                       optim_method=O.SGD(learningrate=0.1), batch_size=32,
                       end_trigger=O.Trigger.max_iteration(3),
                       distributed=distributed)
        finally:
            E.reset()
        out[pkg] = (before, rec.v, _np(sess.run(x[:4])))
    jb, jl, ja = out["jax"]
    tb, tl, ta = out["torch"]
    _close(tb, jb)
    assert len(tl) == len(jl) == 3
    # JAX's Engine spans the test's 8 virtual CPU devices, so its
    # DistriOptimizer sums the gradient over 8 shards of the batch
    # where the port's one rank sums it whole: another f32 order
    tol = 2e-4 if distributed else TOL
    np.testing.assert_allclose(tl, jl, rtol=tol)
    _close(ta, ja, tol)
    assert not np.allclose(ta, tb)          # the weights moved
