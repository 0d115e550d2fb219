"""In-memory datasets: (features, labels) arrays batched for training.

Counterpart of ``bigdl_tpu/dataset/dataset.py``: ``DataSet``,
``ArrayDataSet`` (:52), ``iter_process_batches`` (:145),
``DistributedDataSet`` (:181) and ``to_dataset`` (:291), the ``(x, y)``
tuple case.  Batches are host numpy arrays; the trainer moves them to
its device.  A training pass shuffles with the port's
``RandomGenerator.RNG.randperm``, so a run seeded as a JAX run visits
the batches in the JAX order.

A per-process dataset (``per_process = True``) yields only this
process's rows of each global batch: every process draws the same
permutation and takes its contiguous ``batch // world`` slice.  Its
world is ``torch.distributed``'s rank and size (one process per GPU),
where the JAX package reads ``jax.process_index``/``process_count``.
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


def process_world():
    """(rank, world size) of ``torch.distributed``, or (0, 1) outside a
    process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def iter_process_batches(n: int, batch_size: int, pid: int, nproc: int,
                         shuffle: bool, pad_tail: bool = False):
    """This process's index slice of each full global batch of one
    epoch: one permutation drawn alike on every process (or the order),
    then rows ``[pid * local, (pid + 1) * local)`` of each batch, with
    ``local = batch_size // nproc``.  ``pad_tail`` also yields the
    partial last batch, repeat-padded to a multiple of ``nproc`` (the
    repeated row is counted, as the reference counts its pad copies)."""
    if batch_size % nproc:
        raise ValueError(
            f"global batch {batch_size} not divisible by {nproc} processes")
    local = batch_size // nproc
    idx = RandomGenerator.RNG.randperm(n) if shuffle else np.arange(n)
    for b in range(n // batch_size):
        globl = idx[b * batch_size:(b + 1) * batch_size]
        yield globl[pid * local:(pid + 1) * local]
    rem = n % batch_size
    if pad_tail and rem:
        tail = idx[n - rem:]
        pad_to = -(-rem // nproc) * nproc
        if pad_to != rem:
            tail = np.concatenate([tail, np.repeat(tail[-1:], pad_to - rem)])
        local_t = pad_to // nproc
        yield tail[pid * local_t:(pid + 1) * local_t]


class DistributedDataSet(ArrayDataSet):
    """In-memory per-process dataset: each process yields its own rows
    of every global batch (``iter_process_batches``), the training
    pass's tail included and repeat-padded.  ``process_id`` and
    ``num_processes`` override the process group's rank and size."""

    per_process = True

    def __init__(self, features, labels, batch_size: int = 32,
                 shuffle: bool = True, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None):
        super().__init__(features, labels, batch_size, shuffle)
        self._pid = process_id
        self._nproc = num_processes

    def _world(self):
        if self._pid is not None and self._nproc is not None:
            return self._pid, self._nproc
        return process_world()

    def data(self, train: bool = True):
        pid, nproc = self._world()
        for mine in iter_process_batches(
                self._n, self.batch_size, pid, nproc,
                shuffle=train and self.shuffle, pad_tail=train):
            yield self.features[mine], self.labels[mine]


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


__all__ = ["DataSet", "ArrayDataSet", "DistributedDataSet",
           "iter_process_batches", "process_world", "to_dataset"]
