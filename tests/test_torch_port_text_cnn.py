"""The text-classification CNN and its serving forms in the port, on the
CPU, against the JAX examples.

- ``synthetic_news20``, ``synthetic_glove``, ``get_news20`` and
  ``get_glove_w2v`` give the JAX package's documents and vectors;
  ``tokenize_corpus``/``encode_texts`` the JAX example's ids, bit for
  bit.
- ``build_text_cnn`` draws the JAX example's weights from one seed, and
  3 ``Adam`` steps through both ``LocalOptimizer``s agree within 1e-5
  (losses and parameters).
- ``make_predict_udf`` and ``DLClassifierModel.transform`` give the JAX
  example's class ids on the same weights, the log-probabilities within
  1e-5.
- ``main`` of both port examples runs on ``--device cpu``.
"""

import importlib.util
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import news20 as JNews
from bigdl_tpu.dlframes import DLClassifierModel as JDLModel
from bigdl_tpu.nn import ClassNLLCriterion as JNLL
from bigdl_tpu.optim.evaluator import predict as j_predict
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import news20 as TNews
from bigdl_tpu_torch.dlframes import DLClassifierModel as TDLModel
from bigdl_tpu_torch.examples import train_text_cnn as TX
from bigdl_tpu_torch.examples import udf_predict as TU
from bigdl_tpu_torch.nn import ClassNLLCriterion as TNLL
from bigdl_tpu_torch.optim.evaluator import predict as t_predict
from bigdl_tpu_torch.utils import tree as T
from bigdl_tpu_torch.utils.convert import load_jax_params

from torch_port_parity import rel

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC_LEN = 16


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JX = _load("jax_train_text_cnn", "textclassification", "train_text_cnn.py")
JU = _load("jax_udf_predict", "udfpredict", "udf_predict.py")


def _corpus(n=256, doc_len=DOC_LEN):
    docs = TNews.synthetic_news20(n, class_num=4)
    return docs, TX.tokenize_corpus(docs, doc_len), JX.tokenize_corpus(
        docs, doc_len)


def test_synthetic_corpus_and_vectors_match_jax():
    for args in ((64,), (200, 3, 5)):
        assert TNews.synthetic_news20(*args) == JNews.synthetic_news20(*args)
    vocab = ["word1", "common3", "zebra"]
    got, want = TNews.synthetic_glove(vocab, 8), JNews.synthetic_glove(
        vocab, 8)
    for w in vocab:
        np.testing.assert_array_equal(got[w], want[w])
    assert TNews.CLASS_NUM == JNews.CLASS_NUM == 20


def test_corpus_files_read_as_jax(tmp_path):
    root = tmp_path / "20news-18828"
    for g, posts in (("alt.atheism", ["god\n", "faith é"]),
                     ("sci.space", ["orbit", "rocket fuel"])):
        (root / g).mkdir(parents=True)
        for i, text in enumerate(posts):
            (root / g / f"{i}").write_bytes(text.encode("latin-1"))
    (tmp_path / "glove.6B").mkdir()
    (tmp_path / "glove.6B" / "glove.6B.3d.txt").write_text(
        "the 0.1 0.2 0.3\nspace -1 0 1.5\n")
    assert TNews.get_news20(str(tmp_path)) == JNews.get_news20(str(tmp_path))
    got = TNews.get_glove_w2v(str(tmp_path / "glove.6B"), 3)
    want = JNews.get_glove_w2v(str(tmp_path / "glove.6B"), 3)
    assert sorted(got) == sorted(want)
    for w in got:
        np.testing.assert_array_equal(got[w], want[w])
    empty = tmp_path / "none"
    empty.mkdir()
    for fn in (TNews.get_news20, TNews.get_glove_w2v):
        try:
            fn(str(empty))
        except FileNotFoundError as e:
            assert "download" in str(e)
        else:
            raise AssertionError("no FileNotFoundError")


def test_tokenize_and_encode_are_the_jax_examples():
    docs, (tx, ty, tdic), (jx, jy, jdic) = _corpus()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert len(tdic) == len(jdic)
    texts = ["word3 word3 unknown COMMON1", "", "word40 " * 40]
    np.testing.assert_array_equal(TX.encode_texts(texts, tdic, DOC_LEN),
                                  JX.encode_texts(texts, jdic, DOC_LEN))


def _models(vocab, n_classes=4, seed=3):
    JRandom.RNG.set_seed(seed)
    jm = JX.build_text_cnn(vocab, n_classes=n_classes, doc_len=DOC_LEN)
    TRandom.RNG.set_seed(seed)
    tm = TX.build_text_cnn(vocab, n_classes=n_classes, doc_len=DOC_LEN,
                           device="cpu")
    return jm, tm


class _Losses:
    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value

    def get_summary_trigger(self, name):
        return None


def _fixed(base, x, y, bs):
    class Fixed(base):
        def size(self):
            return len(x)

        def data(self, train=True):
            for b in range(0, len(x), bs):
                yield x[b:b + bs], y[b:b + bs]

    return Fixed()


def test_three_adam_steps_match_jax():
    # the JAX example's doc_len: its 30-word documents end in two 0 ids
    docs, (x, y, dic), _ = _corpus(96, doc_len=32)
    assert (x[:, -2:] == 0).all()
    jm, tm = _models(len(dic) + 1)
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    losses = {}
    for pkg, m in (("jax", jm), ("torch", tm)):
        if pkg == "jax":
            opt = JLocal(m, _fixed(JDataSet, x, y, 32), JNLL(), 32)
            O = JO
        else:
            opt = TO.LocalOptimizer(m, _fixed(TDataSet, x, y, 32), TNLL(),
                                    32, device="cpu")
            O = TO
        opt.set_optim_method(O.Adam(learningrate=0.05))
        opt.set_end_when(O.Trigger.max_iteration(3))
        losses[pkg] = _Losses()
        opt.set_train_summary(losses[pkg])
        opt.optimize()
    jl, tl = losses["jax"].loss, losses["torch"].loss
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for n in tl:
        assert abs(tl[n] - jl[n]) <= TOL * max(1.0, abs(jl[n])), (tl, jl)
    for a, b in zip(T.leaves(tm.params()), jax.tree.leaves(jm.params())):
        assert rel(a, b) <= TOL


def test_udf_and_transform_match_the_jax_example():
    docs, (x, y, tdic), (_, _, jdic) = _corpus(128)
    jm, tm = _models(len(tdic) + 1, seed=8)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    texts = [d for d, _ in docs[:24]] + ["nothing known here", ""]
    want = JU.make_predict_udf(jm, jdic, DOC_LEN)(texts)
    udf = TU.make_predict_udf(tm, tdic, DOC_LEN, device="cpu")
    got = udf(texts)
    np.testing.assert_array_equal(got, want)
    assert udf(texts[3]) == int(want[3])
    feats = TX.encode_texts(texts, tdic, DOC_LEN)
    assert rel(t_predict(tm, feats, device="cpu"),
               np.asarray(j_predict(jm, jnp.asarray(feats)))) <= TOL
    df = {"text": texts, "features": [row for row in feats]}
    t_out = TDLModel(tm, feature_size=[DOC_LEN], device="cpu").transform(df)
    j_out = JDLModel(jm, feature_size=[DOC_LEN]).transform(df)
    np.testing.assert_array_equal(np.asarray(t_out["prediction"]),
                                  np.asarray(j_out["prediction"]))
    np.testing.assert_array_equal(np.asarray(t_out["prediction"]), got)


class _Scalars:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, step, value))


def test_examples_run_on_the_cpu():
    TRandom.RNG.set_seed(0)
    losses, vals = _Scalars(), _Scalars()
    opt = TX.main(["--device", "cpu", "-e", "1", "--doc-len", "16"],
                  train_summary=losses, val_summary=vals)
    top1 = [v for t, _, v in vals.rows if t == "Top1Accuracy"]
    assert len(top1) == 1 and top1[0] >= 0.9
    assert len([r for r in losses.rows if r[0] == "Loss"]) == 10
    assert next(opt.model.parameters()).device.type == "cpu"
    acc = TU.main(["--device", "cpu", "--max-epoch", "1", "--doc-len",
                   "16"])
    assert 0.0 <= acc <= 1.0
