"""The port's DataFrame API (``bigdl_tpu_torch.dlframes``) and
``PartitionStreamDataSet`` against the JAX package, on the CPU.

Both packages fit the same initial weights (the port's model carries
the JAX model's through ``load_jax_params``) on the same frame, with
``RandomGenerator`` seeded alike so that the shuffles agree.  Limits:
predicted classes equal JAX's; fitted weights and regression outputs
within 1e-5 (absolute; f32 SGD steps whose sums run in other orders);
the partition-streamed path equal to the dict path, and its batches
equal to JAX's."""

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as JN
from bigdl_tpu import optim as JO
from bigdl_tpu.common import RandomGenerator as JRandom
from bigdl_tpu.dataset import PartitionStreamDataSet as JStream
from bigdl_tpu.dlframes import DLClassifier as JClassifier
from bigdl_tpu.dlframes import DLEstimator as JEstimator
from bigdl_tpu.dlframes.dl_estimator import _RddPartitionSource as JSource
from bigdl_tpu.models.lenet import build_lenet5 as j_lenet
from bigdl_tpu_torch import nn as TN
from bigdl_tpu_torch import optim as TO
from bigdl_tpu_torch.common import RandomGenerator as TRandom
from bigdl_tpu_torch.dataset import PartitionStreamDataSet as TStream
from bigdl_tpu_torch.dlframes import DLClassifier, DLEstimator, DLModel
from bigdl_tpu_torch.dlframes.dl_estimator import _RddPartitionSource
from bigdl_tpu_torch.models.lenet import build_lenet5 as t_lenet
from bigdl_tpu_torch.utils.convert import load_jax_params

W_TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v)
    return out


def _close_weights(tm, jm):
    jp, tp = _flat(jax.tree.map(np.asarray, jm.params())), _flat(tm.params())
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=W_TOL, err_msg=k)


def _toy_df(n=128, d=6, k=3, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, k)
    x = rng.randn(n, d).astype(np.float32)
    y = (np.argmax(x @ w, axis=1) + 1).astype(np.float32)
    return {"features": [row for row in x], "label": y}, x, y


def _twins(build):
    """(JAX model, port model) with the same weights."""
    JRandom.RNG.set_seed(3)
    jm = build(JN)
    tm = build(TN)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    return jm, tm


def _linear(P):
    return P.Sequential().add(P.Linear(6, 3)).add(P.LogSoftMax())


def _seed_shuffles():
    JRandom.RNG.set_seed(1)
    TRandom.RNG.set_seed(1)


def _fit_both(jest, test, df):
    _seed_shuffles()
    jfit = jest.fit(df)
    _seed_shuffles()
    tfit = test.fit(df)
    return jfit, tfit


def test_dl_classifier_dict_matches_jax():
    df, x, y = _toy_df()
    jm, tm = _twins(_linear)
    jc = JClassifier(jm, feature_size=[6]).set_batch_size(32) \
        .set_optim_method(JO.SGD(learningrate=0.5)).set_max_epoch(15)
    tc = DLClassifier(tm, feature_size=[6], device="cpu").set_batch_size(32) \
        .set_optim_method(TO.SGD(learningrate=0.5)).set_max_epoch(15)
    jfit, tfit = _fit_both(jc, tc, df)
    _close_weights(tfit.model, jfit.model)
    jpred = np.asarray(jfit.transform(df)["prediction"])
    out = tfit.transform(df)
    tpred = np.asarray(out["prediction"])
    np.testing.assert_array_equal(tpred, jpred)
    assert float(np.mean(tpred == y)) > 0.9 and tpred.min() >= 1
    assert set(out) == {"features", "label", "prediction"}
    assert "prediction" not in df


def test_dl_classifier_pandas_matches_jax():
    pd = pytest.importorskip("pandas")
    d, x, y = _toy_df(64)
    df = pd.DataFrame({"features": d["features"], "label": d["label"]})
    jm, tm = _twins(_linear)
    jc = JClassifier(jm, feature_size=[6]).setBatchSize(32) \
        .setOptimMethod(JO.SGD(learningrate=0.5)).setMaxEpoch(10)
    tc = DLClassifier(tm, feature_size=[6], device="cpu").setBatchSize(32) \
        .setOptimMethod(TO.SGD(learningrate=0.5)).setMaxEpoch(10)
    jfit, tfit = _fit_both(jc, tc, df)
    _close_weights(tfit.model, jfit.model)
    out = tfit.transform(df)
    assert isinstance(out, pd.DataFrame) and "prediction" in out.columns
    np.testing.assert_array_equal(
        np.asarray(out["prediction"]),
        np.asarray(jfit.transform(df)["prediction"]))


def test_dl_estimator_mse_regression_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(128, 4).astype(np.float32)
    w = rng.randn(4, 2).astype(np.float32)
    y = x @ w
    df = {"features": [r for r in x], "label": [r for r in y]}
    jm, tm = _twins(lambda P: P.Sequential().add(P.Linear(4, 2)))
    je = JEstimator(jm, JN.MSECriterion(), [4], [2]).set_batch_size(32) \
        .set_optim_method(JO.SGD(learningrate=0.1)).set_max_epoch(30)
    te = DLEstimator(tm, TN.MSECriterion(), [4], [2], device="cpu") \
        .set_batch_size(32).set_optim_method(TO.SGD(learningrate=0.1)) \
        .set_max_epoch(30)
    jfit, tfit = _fit_both(je, te, df)
    _close_weights(tfit.model, jfit.model)
    tpred = np.stack(tfit.transform(df)["prediction"])
    jpred = np.stack(jfit.transform(df)["prediction"])
    assert tpred.shape == (128, 2)
    np.testing.assert_allclose(tpred, jpred, atol=W_TOL)
    assert float(np.mean((tpred - y) ** 2)) < 0.05


def test_feature_reshape_to_image_matches_jax():
    """featureSize reshape: flat 784 vectors -> (28, 28) LeNet-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(32, 784).astype(np.float32)
    y = (rng.randint(0, 10, 32) + 1).astype(np.float32)
    df = {"features": [r for r in x], "label": y}
    JRandom.RNG.set_seed(3)
    jm = j_lenet()
    tm = t_lenet(device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params()))
    jc = JClassifier(jm, feature_size=[28, 28]).set_batch_size(16) \
        .set_max_epoch(1)
    tc = DLClassifier(tm, feature_size=[28, 28], device="cpu") \
        .set_batch_size(16).set_max_epoch(1)
    jfit, tfit = _fit_both(jc, tc, df)
    _close_weights(tfit.model, jfit.model)
    out = tfit.transform(df)
    assert len(out["prediction"]) == 32
    np.testing.assert_array_equal(
        np.asarray(out["prediction"]),
        np.asarray(jfit.transform(df)["prediction"]))


class _FakeRdd:
    """The pyspark RDD calls ``_RddPartitionSource`` makes, counting the
    largest collect() so that a test can see the streaming."""

    def __init__(self, rows, n_parts, stats, fn=None):
        self.rows, self.n_parts, self.stats, self._fn = rows, n_parts, \
            stats, fn

    def getNumPartitions(self):
        return self.n_parts

    def mapPartitionsWithIndex(self, fn):
        return _FakeRdd(self.rows, self.n_parts, self.stats, fn)

    def collect(self):
        per = -(-len(self.rows) // self.n_parts)
        out = []
        for i in range(self.n_parts):
            it = iter(self.rows[i * per:(i + 1) * per])
            out.extend(self._fn(i, it) if self._fn else it)
        self.stats["max_collect"] = max(self.stats["max_collect"], len(out))
        return out


class _FakeSparkDF:
    def __init__(self, feats, labels, n_parts=4):
        self.feats, self.labels, self.n_parts = feats, labels, n_parts
        self.stats = {"max_collect": 0}

    @property
    def rdd(self):
        rows = list(zip(self.feats.tolist(), self.labels.tolist()))
        return _FakeRdd(rows, self.n_parts, self.stats)

    def collect(self):
        raise AssertionError("a full DataFrame collect() must not happen")

    def select(self, *cols):
        return self

    def toPandas(self):
        import pandas as pd

        return pd.DataFrame({"features": list(self.feats),
                             "label": self.labels})


def test_spark_partition_streamed_path_equals_dict_path():
    """fit() on a spark-protocol frame streams one partition at a time;
    with no shuffle on either side (the stream keeps partition order,
    the dict frame is fitted unshuffled here) both paths give the same
    weights, and transform the same predictions."""
    pytest.importorskip("pandas")
    rs = np.random.RandomState(0)
    w = rs.randn(6, 3)
    feats = rs.randn(240, 6).astype(np.float32)
    labels = (np.argmax(feats @ w, axis=1) + 1).astype(np.float32)
    sdf = _FakeSparkDF(feats, labels, n_parts=6)
    jm, tm = _twins(_linear)
    _, tm2 = _twins(_linear)
    tc = DLClassifier(tm, feature_size=[6], device="cpu") \
        .set_batch_size(20).set_max_epoch(30).set_learning_rate(0.5)
    fitted = tc.fit(sdf)
    assert sdf.stats["max_collect"] == 40, sdf.stats   # one partition

    from bigdl_tpu_torch.dataset import ArrayDataSet

    ref = TO.LocalOptimizer(tm2, ArrayDataSet(feats, labels, 20,
                                              shuffle=False),
                            TN.ClassNLLCriterion(), batch_size=20,
                            device="cpu")
    ref.set_optim_method(TO.SGD(learningrate=0.5))
    ref.set_end_when(TO.Trigger.max_epoch(30))
    ref.optimize()
    for k, v in _flat(tm2.params()).items():
        np.testing.assert_array_equal(_flat(fitted.model.params())[k], v,
                                      err_msg=k)
    out = fitted.transform(sdf)
    preds = np.asarray(out["prediction"], np.float32)
    dict_preds = DLModel(tm2, [6], device="cpu").transform(
        {"features": list(feats)})["prediction"]
    np.testing.assert_array_equal(
        preds, np.argmax(np.stack(dict_preds), axis=1) + 1.0)
    assert float(np.mean(preds == labels)) > 0.9
    # and the JAX package's spark path reaches the same weights
    jc = JClassifier(jm, feature_size=[6]).set_batch_size(20) \
        .set_max_epoch(30).set_learning_rate(0.5)
    jfit = jc.fit(_FakeSparkDF(feats, labels, n_parts=6))
    _close_weights(fitted.model, jfit.model)


@pytest.mark.parametrize("pid,nproc", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("train", [True, False])
def test_partition_stream_batches_equal_jax(pid, nproc, train):
    rs = np.random.RandomState(4)
    feats = rs.randn(70, 12).astype(np.float32)
    labels = (rs.randint(0, 3, 70) + 1).astype(np.float32)
    df = _FakeSparkDF(feats, labels, n_parts=5)
    kw = dict(batch_size=8, feature_size=[3, 4], label_size=[1],
              process_id=pid, num_processes=nproc)
    jb = list(JStream(JSource(df, "features", "label"), **kw).data(train))
    tb = list(TStream(_RddPartitionSource(df, "features", "label"),
                      **kw).data(train))
    assert len(tb) == len(jb) > 0
    for (tx, ty), (jx, jy) in zip(tb, jb):
        assert tx.shape[1:] == (3, 4) and ty.ndim == 1
        np.testing.assert_array_equal(tx, np.asarray(jx))
        np.testing.assert_array_equal(ty, np.asarray(jy))


def test_dlframes_need_the_card_unless_cpu_is_asked():
    _, tm = _twins(_linear)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLClassifier(tm, feature_size=[6])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLModel(tm, [6])
    with pytest.raises(TypeError, match="unsupported DataFrame"):
        DLModel(tm, [6], device="cpu").transform([1, 2, 3])
