"""In-memory datasets: (features, labels) arrays batched for training.

Counterpart of ``bigdl_tpu/dataset/dataset.py``: ``DataSet``,
``ArrayDataSet`` (:52) and ``to_dataset`` (:291), the ``(x, y)`` tuple
case.  Batches are host numpy arrays; the trainer moves them to its
device.  A training pass shuffles with the port's
``RandomGenerator.RNG.randperm``, so a run seeded as a JAX run visits
the batches in the JAX order.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.common import RandomGenerator


class DataSet:
    """Iterable of (input, target) numpy batches."""

    def data(self, train: bool = True) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


class ArrayDataSet(DataSet):
    """(features, labels) arrays batched to (input, target).  Training
    passes shuffle and drop the ragged tail batch; eval passes keep
    the order and the tail."""

    def __init__(self, features, labels, batch_size: int = 32,
                 shuffle: bool = True):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._n = self.features.shape[0]

    def size(self):
        return self._n

    def data(self, train: bool = True):
        idx = np.arange(self._n)
        if train and self.shuffle:
            idx = RandomGenerator.RNG.randperm(self._n)
        bs = self.batch_size
        n_full = self._n // bs
        for b in range(n_full):
            sel = idx[b * bs:(b + 1) * bs]
            yield self.features[sel], self.labels[sel]
        if self._n > n_full * bs and not train:
            sel = idx[n_full * bs:]
            yield self.features[sel], self.labels[sel]


def to_dataset(data, batch_size: int = 32) -> Optional[DataSet]:
    """A ``DataSet`` as it is, or an ``(x, y)`` tuple as an
    ``ArrayDataSet``."""
    if data is None:
        return None
    if isinstance(data, DataSet):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        return ArrayDataSet(data[0], data[1], batch_size)
    raise TypeError(f"cannot build a DataSet from {type(data)}")


__all__ = ["DataSet", "ArrayDataSet", "to_dataset"]
