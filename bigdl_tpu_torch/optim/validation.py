"""Validation methods and their results.

Counterpart of ``bigdl_tpu/optim/validation.py``: ``ValidationResult``
(:15), ``ValidationMethod`` (:36), ``Top1Accuracy`` (:49),
``Top5Accuracy`` (:62), ``Loss`` (:77) and ``MAE`` (:93).  Each method
folds one batch's model output, copied to the host, into a (sum, count)
result in numpy; results add across batches.  ``Top5Accuracy`` ranks
with numpy's ``argpartition``, as JAX does, so ties break the same way.
"""

from __future__ import annotations

import numpy as np
import torch


class ValidationResult:
    """(sum, count) monoid; ``result()`` is (sum / count, count)."""

    def __init__(self, total: float, count: int, name: str = ""):
        self.total = float(total)
        self.count = int(count)
        self.name = name

    def result(self):
        return (self.total / max(1, self.count), self.count)

    def __add__(self, other):
        return ValidationResult(self.total + other.total,
                                self.count + other.count, self.name)

    def __repr__(self):
        v, c = self.result()
        return f"{self.name or 'ValidationResult'}: {v:.6f} (count {c})"


class ValidationMethod:
    name = "ValidationMethod"

    def batch_result(self, output, target) -> ValidationResult:
        """One batch's partial result from the host output and
        target."""
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    """argmax + 1 against the 1-based target."""

    name = "Top1Accuracy"

    def batch_result(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target).reshape(-1).astype(np.int64)
        pred = np.argmax(out.reshape(-1, out.shape[-1]), axis=-1) + 1
        return ValidationResult(int(np.sum(pred == t)), t.size, self.name)


class Top5Accuracy(ValidationMethod):
    """The 1-based target among the five largest outputs."""

    name = "Top5Accuracy"

    def batch_result(self, output, target):
        out = np.asarray(output)
        out2 = out.reshape(-1, out.shape[-1])
        t = np.asarray(target).reshape(-1).astype(np.int64)
        k = min(5, out2.shape[-1])
        top5 = np.argpartition(-out2, k - 1, axis=-1)[:, :k] + 1
        correct = int(np.sum(np.any(top5 == t[:, None], axis=1)))
        return ValidationResult(correct, t.size, self.name)


class Loss(ValidationMethod):
    """The criterion's value averaged over samples (default the port's
    ``ClassNLLCriterion``), computed on the host."""

    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

        self.criterion = criterion or ClassNLLCriterion()

    def batch_result(self, output, target):
        n = np.asarray(target).reshape(-1).shape[0]
        val = float(self.criterion.loss(torch.as_tensor(np.asarray(output)),
                                        torch.as_tensor(np.asarray(target))))
        return ValidationResult(val * n, n, self.name)


class MAE(ValidationMethod):
    """Mean absolute error, per element of a sample."""

    name = "MAE"

    def batch_result(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target)
        n = out.shape[0]
        return ValidationResult(
            float(np.sum(np.abs(out - t))) / max(1, out[0].size), n,
            self.name)


__all__ = ["ValidationResult", "ValidationMethod", "Top1Accuracy",
           "Top5Accuracy", "Loss", "MAE"]
