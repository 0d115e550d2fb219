"""DLEstimator / DLClassifier / DLModel: DataFrame in, DataFrame out.

Counterpart of ``bigdl_tpu/dlframes/dl_estimator.py`` (BASELINE config
5):

    DLEstimator.fit(df):   DataFrame columns -> (features, labels)
                           reshaped by feature_size / label_size ->
                           LocalOptimizer -> DLModel
    DLModel.transform(df): batched eval forward (``optim.evaluator.
                           predict``) -> a prediction column
    DLClassifier:          ClassNLLCriterion, 1-based labels, argmax + 1
                           in transform

DataFrames: a plain dict of columns, a pandas DataFrame, or a frame
with a (py)spark RDD (``.rdd`` and ``.collect``), which is streamed one
partition at a time (``PartitionStreamDataSet``) and never collected
whole.  The model trains and predicts on ``device`` (default the card;
raises without CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.common import resolve_device


def _df_kind(df):
    if hasattr(df, "rdd") and hasattr(df, "collect"):
        return "spark"
    if hasattr(df, "columns") and hasattr(df, "iloc"):
        return "pandas"
    if isinstance(df, dict):
        return "dict"
    raise TypeError(f"unsupported DataFrame type {type(df)}")


class _RddPartitionSource:
    """Row source over a (py)spark-protocol RDD, one partition at a time
    (a job per partition), so the host holds at most the largest
    partition.  The RDD needs ``getNumPartitions()`` and
    ``mapPartitionsWithIndex(f).collect()``."""

    def __init__(self, df, features_col: str, label_col: Optional[str]):
        cols = [features_col] + ([label_col] if label_col else [])
        self._rdd = df.select(*cols).rdd
        self._has_label = label_col is not None

    def num_partitions(self) -> int:
        return self._rdd.getNumPartitions()

    def iter_partition(self, i: int):
        def keep(idx, it):
            return it if idx == i else iter(())

        for row in self._rdd.mapPartitionsWithIndex(keep).collect():
            feat = np.asarray(row[0], np.float32)
            lbl = np.asarray(row[1], np.float32) if self._has_label \
                else np.zeros((), np.float32)
            yield feat, lbl


def _column(df, name):
    kind = _df_kind(df)
    if kind == "spark":
        return np.asarray([row[name] for row in df.select(name).collect()],
                          dtype=np.float32)
    if kind == "pandas":
        return np.asarray(df[name].tolist(), dtype=np.float32)
    return np.asarray(df[name], dtype=np.float32)


def _with_column(df, name, values):
    kind = _df_kind(df)
    if kind == "spark":
        # predictions are a host product: the spark frame comes back as
        # a pandas frame with the new column
        pdf = df.toPandas()
        pdf[name] = list(values)
        return pdf
    if kind == "pandas":
        out = df.copy()
        out[name] = list(values)
        return out
    out = dict(df)
    out[name] = values
    return out


class DLModel:
    """A fitted model: ``transform`` adds the prediction column (each
    row's output, flattened)."""

    def __init__(self, model, feature_size: Sequence[int],
                 features_col: str = "features",
                 prediction_col: str = "prediction",
                 batch_size: int = 32, device="cuda"):
        self.model = model
        self.feature_size = list(feature_size)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def set_features_col(self, name):
        self.features_col = name
        return self

    def set_prediction_col(self, name):
        self.prediction_col = name
        return self

    def set_batch_size(self, n):
        self.batch_size = n
        return self

    setFeaturesCol = set_features_col
    setPredictionCol = set_prediction_col
    setBatchSize = set_batch_size

    def _predict(self, feats):
        from bigdl_tpu_torch.optim.evaluator import predict

        return predict(self.model, feats.reshape([-1] + self.feature_size),
                       self.batch_size, self.device)

    def _predict_raw(self, df):
        if _df_kind(df) == "spark":
            # per-partition predict: bounded host memory
            src = _RddPartitionSource(df, self.features_col, None)
            outs = []
            for p in range(src.num_partitions()):
                rows = [feat for feat, _ in src.iter_partition(p)]
                if rows:
                    outs.append(self._predict(np.stack(rows)))
            return np.concatenate(outs, axis=0)
        return self._predict(_column(df, self.features_col))

    def transform(self, df):
        out = self._predict_raw(df)
        return _with_column(df, self.prediction_col,
                            [row for row in out.reshape(out.shape[0], -1)])


class DLClassifierModel(DLModel):
    """A fitted classifier: the prediction is the 1-based argmax."""

    def transform(self, df):
        out = self._predict_raw(df)
        preds = np.argmax(out.reshape(out.shape[0], -1), axis=1) + 1.0
        return _with_column(df, self.prediction_col, preds)


class DLEstimator:
    """``fit(df)`` trains ``model`` on the DataFrame's columns through
    ``LocalOptimizer`` and returns a :class:`DLModel`."""

    _model_cls = DLModel

    def __init__(self, model, criterion, feature_size: Sequence[int],
                 label_size: Sequence[int],
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction", device="cuda"):
        self.model = model
        self.criterion = criterion
        self.feature_size = list(feature_size)
        self.label_size = list(label_size)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.device = resolve_device(device)
        self.batch_size = 32
        self.max_epoch = 10
        self.learning_rate = 1e-3
        self.optim_method = None
        self.end_trigger = None

    # fluent setters (reference Param spellings below)
    def set_batch_size(self, n):
        self.batch_size = n
        return self

    def set_max_epoch(self, n):
        self.max_epoch = n
        return self

    def set_learning_rate(self, lr):
        self.learning_rate = lr
        return self

    def set_optim_method(self, m):
        self.optim_method = m
        return self

    def set_end_when(self, trigger):
        self.end_trigger = trigger
        return self

    def set_features_col(self, name):
        self.features_col = name
        return self

    def set_label_col(self, name):
        self.label_col = name
        return self

    setBatchSize = set_batch_size
    setMaxEpoch = set_max_epoch
    setLearningRate = set_learning_rate
    setOptimMethod = set_optim_method
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col

    def fit(self, df) -> DLModel:
        from bigdl_tpu_torch.dataset import PartitionStreamDataSet
        from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

        if _df_kind(df) == "spark":
            # partition-streamed feed: the frame is never collected
            data = PartitionStreamDataSet(
                _RddPartitionSource(df, self.features_col, self.label_col),
                batch_size=self.batch_size,
                feature_size=self.feature_size,
                label_size=self.label_size)
        else:
            feats = _column(df, self.features_col).reshape(
                [-1] + self.feature_size)
            labels = _column(df, self.label_col).reshape(
                [-1] + self.label_size)
            if self.label_size == [1]:
                labels = labels.reshape(-1)
            data = (feats, labels)
        opt = LocalOptimizer(self.model, data, self.criterion,
                             batch_size=self.batch_size, device=self.device)
        opt.set_optim_method(
            self.optim_method or SGD(learningrate=self.learning_rate))
        opt.set_end_when(self.end_trigger
                         or Trigger.max_epoch(self.max_epoch))
        trained = opt.optimize()
        return self._model_cls(trained, self.feature_size, self.features_col,
                               self.prediction_col, self.batch_size,
                               self.device)


class DLClassifier(DLEstimator):
    """A DLEstimator over a label column of 1-based class ids
    (``ClassNLLCriterion`` by default, scalar labels)."""

    _model_cls = DLClassifierModel

    def __init__(self, model, criterion=None, feature_size=None,
                 features_col="features", label_col="label",
                 prediction_col="prediction", device="cuda"):
        from bigdl_tpu_torch.nn import ClassNLLCriterion

        super().__init__(model, criterion or ClassNLLCriterion(),
                         feature_size, [1], features_col, label_col,
                         prediction_col, device)


__all__ = ["DLEstimator", "DLClassifier", "DLModel", "DLClassifierModel"]
