"""Prediction and evaluation on one device.

Counterpart of the single-device half of ``bigdl_tpu/optim/
evaluator.py``: ``evaluate_dataset`` (:110), ``predict`` (:163),
``predict_class`` (:193), ``Evaluator`` (:234), ``Validator`` (:252)
and ``Predictor`` (:286).  The model runs its eval-mode forward under
``no_grad`` on ``device`` (default the card; raises without CUDA unless
``device="cpu"``), with the parameters it holds (a trainer validates on
its live weights, no copy); each batch's output comes to the host, where
the validation methods fold it in numpy.  Batches go in the dataset's
eval order, the ragged tail included (``ArrayDataSet.data(train=False)``).
There is no mesh: every batch runs whole on the one device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.dataset import to_dataset


def _forward(model, inp, dev) -> np.ndarray:
    x = torch.as_tensor(np.asarray(inp), device=dev)
    return model(x).float().cpu().numpy()


def evaluate_dataset(model, dataset, methods: Sequence, device="cuda"):
    """Fold ``methods`` over ``dataset``: one ``ValidationResult`` per
    method, in order (JAX ``evaluate_dataset``)."""
    dev = resolve_device(device)
    model.to(dev).evaluate()
    results = [None] * len(methods)
    with torch.no_grad():
        for inp, tgt in dataset.data(train=False):
            out = _forward(model, inp, dev)
            for i, m in enumerate(methods):
                r = m.batch_result(out, tgt)
                results[i] = r if results[i] is None else results[i] + r
    return results


def predict(model, features, batch_size: int = 32, device="cuda"):
    """The eval-mode outputs over ``features`` in batches, stacked on the
    host (JAX ``predict``; array input only)."""
    dev = resolve_device(device)
    model.to(dev).evaluate()
    feats = np.asarray(features)
    with torch.no_grad():
        outs = [_forward(model, feats[b:b + batch_size], dev)
                for b in range(0, feats.shape[0], batch_size)]
    return np.concatenate(outs, axis=0)


def predict_class(model, features, batch_size: int = 32, device="cuda"):
    """The 1-based class of each sample: argmax + 1."""
    out = predict(model, features, batch_size, device)
    return np.argmax(out.reshape(out.shape[0], -1), axis=-1) + 1


class Evaluator:
    """``Evaluator(model).test(dataset, methods)``."""

    def __init__(self, model, device="cuda"):
        self.model = model
        self.device = device

    def test(self, dataset, methods: Sequence, batch_size: int = 32):
        return evaluate_dataset(self.model, to_dataset(dataset, batch_size),
                                methods, self.device)


class Validator:
    """``Validator(model, dataset).test(methods)``; ``LocalValidator``
    is the same class."""

    def __init__(self, model, dataset=None, batch_size: int = 32,
                 device="cuda"):
        self.model = model
        self.dataset = (to_dataset(dataset, batch_size)
                        if dataset is not None else None)
        self.device = device

    def test(self, methods: Sequence, dataset=None, batch_size=None):
        if dataset is not None:
            ds = to_dataset(dataset, batch_size or 32)
        else:
            ds = self.dataset
            if ds is not None and batch_size is not None:
                ds = to_dataset((ds.features, ds.labels), batch_size) \
                    if hasattr(ds, "features") else ds
        if ds is None:
            raise ValueError("Validator needs a dataset (constructor or "
                             "test argument)")
        return evaluate_dataset(self.model, ds, methods, self.device)


LocalValidator = Validator


class Predictor:
    """``Predictor(model).predict(features)``; ``predict_class`` gives
    1-based labels."""

    def __init__(self, model, batch_size: int = 32, device="cuda"):
        self.model = model
        self.batch_size = batch_size
        self.device = device

    def predict(self, features):
        return predict(self.model, features, self.batch_size, self.device)

    def predict_class(self, features):
        return predict_class(self.model, features, self.batch_size,
                             self.device)


__all__ = ["evaluate_dataset", "predict", "predict_class", "Evaluator",
           "Validator", "LocalValidator", "Predictor"]
