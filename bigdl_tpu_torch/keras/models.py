"""Keras ``Sequential`` and ``Model`` with compile/fit/evaluate/predict.

Counterpart of ``bigdl_tpu/keras/models.py``: ``Sequential`` builds a
core ``bigdl_tpu_torch.nn.Sequential`` as layers are added, inferring
shapes, and the Keras training verbs dispatch into the port's trainers
(``LocalOptimizer`` or ``DistriOptimizer``), its evaluator and
``save_module``.  Both take ``device=`` (the card unless the caller asks
for the CPU): each built layer moves there, and training, evaluation
and prediction run there.

``_resolve_loss`` is JAX's as it is.  ``"categorical_crossentropy"``
maps to ``CrossEntropyCriterion``, which takes a log-softmax of its
input, so a model that ends in a softmax applies softmax twice; the
port copies that for parity (``ROADMAP.md``, the differences).
"""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.keras.layers import KerasLayer
from bigdl_tpu_torch.nn import module as M


_LOSSES = {
    "categorical_crossentropy": "_categorical",
    "sparse_categorical_crossentropy": "_sparse",
    "mse": "_mse",
    "mean_squared_error": "_mse",
    "mae": "_mae",
    "binary_crossentropy": "_bce",
    "poisson": "_poisson",
    "cosine_proximity": "_cosine",
    "mape": "_mape",
    "mean_absolute_percentage_error": "_mape",
    "msle": "_msle",
    "mean_squared_logarithmic_error": "_msle",
}


def _resolve_loss(loss):
    from bigdl_tpu_torch.nn import (
        AbsCriterion, BCECriterion, CosineProximityCriterion,
        CrossEntropyCriterion, MeanAbsolutePercentageCriterion,
        MeanSquaredLogarithmicCriterion, MSECriterion, PoissonCriterion,
    )

    if not isinstance(loss, str):
        return loss
    kind = _LOSSES[loss]
    if kind in ("_categorical", "_sparse"):
        return CrossEntropyCriterion()
    if kind == "_mse":
        return MSECriterion()
    if kind == "_mae":
        return AbsCriterion()
    if kind == "_poisson":
        return PoissonCriterion()
    if kind == "_cosine":
        return CosineProximityCriterion()
    if kind == "_mape":
        return MeanAbsolutePercentageCriterion()
    if kind == "_msle":
        return MeanSquaredLogarithmicCriterion()
    return BCECriterion()


def _resolve_optimizer(opt):
    from bigdl_tpu_torch.optim import (SGD, Adadelta, Adagrad, Adam, Adamax,
                                       RMSprop)

    if not isinstance(opt, str):
        return opt
    return {
        "sgd": lambda: SGD(learningrate=0.01),
        "adam": Adam,
        "adagrad": Adagrad,
        "adadelta": Adadelta,
        "adamax": Adamax,
        "rmsprop": RMSprop,
    }[opt.lower()]()


class Sequential:
    """keras.models.Sequential: builds a core ``Sequential`` on
    ``device`` as layers are added, inferring shapes."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.layers: list[KerasLayer] = []
        self.core = M.Sequential().to(self.device)
        self._shape = None  # current output shape (no batch dim)
        self._criterion = None
        self._optim_method = None
        self._metrics = None

    def add(self, layer: KerasLayer):
        if self._shape is None:
            if layer.input_shape is None:
                raise ValueError(
                    "first layer needs input_shape (reference behavior)"
                )
            self._shape = layer.input_shape
        core = layer._built(self._shape)
        self._shape = layer.output_shape
        self.layers.append(layer)
        self.core.add(core.to(self.device))
        return self

    @property
    def output_shape(self):
        return (None,) + tuple(self._shape)

    def summary(self) -> str:
        lines = ["_" * 60]
        lines.append(f"{'Layer (type)':30s}{'Output Shape':20s}")
        for layer in self.layers:
            shape = str((None,) + tuple(layer.output_shape))
            lines.append(f"{type(layer).__name__:30s}{shape:20s}")
        total = sum(int(np.prod(w.shape)) for w in self.get_weights())
        lines.append(f"Total params: {total}")
        lines.append("_" * 60)
        s = "\n".join(lines)
        print(s)
        return s

    # ------------------------------------------------- keras training verbs
    def compile(self, optimizer, loss, metrics=None):
        self._optim_method = _resolve_optimizer(optimizer)
        self._criterion = _resolve_loss(loss)
        self._metrics = metrics
        return self

    def fit(self, x, y, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = False):
        from bigdl_tpu_torch.optim import LocalOptimizer, Top1Accuracy, Trigger
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer

        if self._criterion is None:
            raise RuntimeError("call compile() before fit()")
        y = self._maybe_from_categorical(y)
        cls = DistriOptimizer if distributed else LocalOptimizer
        opt = cls(self.core, (np.asarray(x), y), self._criterion,
                  batch_size=batch_size, device=self.device)
        opt.set_optim_method(self._optim_method)
        opt.set_end_when(Trigger.max_epoch(nb_epoch))
        if validation_data is not None:
            vx, vy = validation_data
            vy = self._maybe_from_categorical(vy)
            methods = [Top1Accuracy()] if self._metrics else None
            if methods:
                opt.set_validation(trigger=Trigger.every_epoch(),
                                   dataset=(np.asarray(vx), vy),
                                   methods=methods)
        opt.optimize()
        self._last_optimizer = opt
        return self

    def _maybe_from_categorical(self, y):
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] > 1 and set(np.unique(y)) <= {0.0, 1.0}:
            # one-hot -> 1-based class ids (keras categorical target)
            return (np.argmax(y, axis=1) + 1).astype(np.float32)
        return y.astype(np.float32)

    def evaluate(self, x, y, batch_size: int = 32):
        from bigdl_tpu_torch.dataset import ArrayDataSet
        from bigdl_tpu_torch.optim import Loss, Top1Accuracy
        from bigdl_tpu_torch.optim.evaluator import evaluate_dataset

        y = self._maybe_from_categorical(y)
        ds = ArrayDataSet(np.asarray(x), y, batch_size)
        methods = [Loss(self._criterion)]
        if self._metrics:
            methods.append(Top1Accuracy())
        results = evaluate_dataset(self.core, ds, methods,
                                   device=self.device)
        return [r.result()[0] for r in results]

    def predict(self, x, batch_size: int = 32):
        from bigdl_tpu_torch.optim.evaluator import predict

        # keras multi-input convention: a tuple OR a list of >=2-D
        # branch arrays is a table input (one array per graph input)
        if isinstance(x, list) and x and all(
                getattr(a, "ndim", 0) >= 2 for a in x):
            x = tuple(np.asarray(a) for a in x)
        elif not isinstance(x, tuple):
            x = np.asarray(x)
        return predict(self.core, x, batch_size, device=self.device)

    def predict_classes(self, x, batch_size: int = 32):
        from bigdl_tpu_torch.optim.evaluator import predict_class

        return predict_class(self.core, np.asarray(x), batch_size,
                             device=self.device) - 1

    # persistence through the core serializer
    def save(self, path: str):
        from bigdl_tpu_torch.utils.serializer import save_module

        return save_module(self.core, path)

    def get_weights(self):
        return self.core.get_weights()

    def set_weights(self, weights):
        self.core.set_weights(weights)
        return self


class Model(Sequential):
    """keras.models.Model: the functional-API training surface over a
    built ``Graph`` (the converter's output for functional JSON
    configs), moved to ``device``.  Inherits Sequential's compile/fit/
    evaluate/predict verbs, which only touch ``self.core``; ``add`` is
    disabled (the graph is already wired)."""

    def __init__(self, core_graph, device="cuda"):
        super().__init__(device=device)
        self.core = core_graph.to(self.device)

    def add(self, layer):
        raise TypeError("Model wraps a finished Graph; use Sequential "
                        "to build layer-by-layer")

    def forward(self, x):
        return self.core(x)
