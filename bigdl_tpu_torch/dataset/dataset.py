"""In-memory datasets: (features, labels) arrays batched for training.

Counterpart of ``bigdl_tpu/dataset/dataset.py``: ``DataSet`` with its
``transform``/``>>`` chaining, ``LocalDataSet`` (:48), ``ArrayDataSet``
(:52), ``SampleDataSet`` (:112), ``iter_process_batches`` (:145),
``DistributedDataSet`` (:181), ``PartitionStreamDataSet`` (:227) and
``to_dataset`` (:291).  Batches are host
numpy arrays; the trainer moves them to its device.  A training pass shuffles with the port's
``RandomGenerator.RNG.randperm``, so a run seeded as a JAX run visits
the batches in the JAX order.

A per-process dataset (``per_process = True``) yields only this
process's rows of each global batch: every process draws the same
permutation and takes its contiguous ``batch // world`` slice.  Its
world is ``torch.distributed``'s rank and size (one process per GPU),
where the JAX package reads ``jax.process_index``/``process_count``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.dataset.sample import Sample, samples_to_minibatch


class DataSet:
    """Iterable of (input, target) numpy batches."""

    def data(self, train: bool = True) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def transform(self, transformer):
        """This dataset's batches through ``transformer`` (an iterator
        -> iterator stage, ``dataset/transformer.py``)."""
        return _TransformedDataSet(self, transformer)

    def __rshift__(self, transformer):
        return self.transform(transformer)


class _TransformedDataSet(DataSet):
    def __init__(self, base: DataSet, transformer):
        self.base = base
        self.transformer = transformer

    def data(self, train: bool = True):
        return self.transformer(self.base.data(train))

    def size(self):
        return self.base.size()


class LocalDataSet(DataSet):
    """A dataset whose every batch is read on this process."""


class ArrayDataSet(LocalDataSet):
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
        # f32 features assemble through the host library's threaded row
        # gather (bigdl_tpu_torch/native, JAX :85-99)
        take = self.features.__getitem__
        if self.features.dtype == np.float32:
            from bigdl_tpu_torch import native

            def take(sel):
                return native.gather_rows(self.features, sel)
        for b in range(n_full):
            sel = idx[b * bs:(b + 1) * bs]
            yield take(sel), self.labels[sel]
        if self._n > n_full * bs and not train:
            sel = idx[n_full * bs:]
            yield take(sel), self.labels[sel]


class SampleDataSet(LocalDataSet):
    """``Sample`` records batched with padding (the reference's
    ``DataSet.array(samples) -> SampleToMiniBatch``): a training pass
    shuffles with ``RandomGenerator.RNG.randperm`` and drops the ragged
    tail, an eval pass keeps the order and the tail."""

    def __init__(self, samples: Sequence[Sample], batch_size: int = 32,
                 padding_value: float = 0.0,
                 fixed_length: Optional[int] = None, shuffle: bool = True):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.padding_value = padding_value
        self.fixed_length = fixed_length
        self.shuffle = shuffle

    def size(self):
        return len(self.samples)

    def _batch(self, idx):
        mb = samples_to_minibatch([self.samples[i] for i in idx],
                                  self.padding_value, self.fixed_length)
        return mb.input, mb.target

    def data(self, train: bool = True):
        n = len(self.samples)
        order = np.arange(n)
        if train and self.shuffle:
            order = RandomGenerator.RNG.randperm(n)
        bs = self.batch_size
        n_full = n // bs
        for b in range(n_full):
            yield self._batch(order[b * bs:(b + 1) * bs])
        if n > n_full * bs and not train:
            yield self._batch(order[n_full * bs:])


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


class PartitionStreamDataSet(DataSet):
    """Batches streamed from a partitioned row source, one partition at
    a time, never the whole dataset on the host (the DataFrame path's
    ``mapPartitions``-style feed, JAX :227-300).

    ``source`` exposes ``num_partitions()`` and ``iter_partition(i)``,
    which yields ``(feature_row, label_row)`` pairs.  This process reads
    the partitions ``i % num_processes == process_id``, in order, and
    batches their rows as they come; ``feature_size`` and
    ``label_size`` reshape a batch's rows (a label size of ``[1]`` gives
    a flat label vector).  A training pass drops the ragged tail batch,
    an eval pass keeps it."""

    def __init__(self, source, batch_size: int = 32,
                 feature_size: Optional[Sequence[int]] = None,
                 label_size: Optional[Sequence[int]] = None,
                 process_id: int = 0, num_processes: int = 1,
                 size_hint: Optional[int] = None):
        self.source = source
        self.batch_size = batch_size
        self.feature_size = list(feature_size) if feature_size else None
        self.label_size = list(label_size) if label_size else None
        self._pid = process_id
        self._nproc = num_processes
        self._size_hint = size_hint

    def size(self):
        return self._size_hint or 0

    @staticmethod
    def _shape(arr, size):
        arr = np.asarray(arr, np.float32)
        if size is not None:
            arr = arr.reshape([arr.shape[0]] + size)
            if size == [1]:
                arr = arr.reshape(-1)
        return arr

    def _batch(self, feats, labels):
        return (self._shape(np.stack(feats), self.feature_size),
                self._shape(np.stack(labels), self.label_size))

    def data(self, train: bool = True):
        feats: list = []
        labels: list = []
        for p in range(self.source.num_partitions()):
            if p % self._nproc != self._pid:
                continue
            for feat, lbl in self.source.iter_partition(p):
                feats.append(np.asarray(feat, np.float32))
                labels.append(np.asarray(lbl, np.float32))
                if len(feats) == self.batch_size:
                    yield self._batch(feats, labels)
                    feats, labels = [], []
        if feats and not train:
            yield self._batch(feats, labels)


def to_dataset(data, batch_size: int = 32) -> Optional[DataSet]:
    """A ``DataSet`` as it is, an ``(x, y)`` tuple as an
    ``ArrayDataSet``, or a list of ``Sample``s as a ``SampleDataSet``."""
    if data is None:
        return None
    if isinstance(data, DataSet):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        return ArrayDataSet(data[0], data[1], batch_size)
    if isinstance(data, list) and data and isinstance(data[0], Sample):
        return SampleDataSet(data, batch_size)
    raise TypeError(f"cannot build a DataSet from {type(data)}")


__all__ = ["DataSet", "LocalDataSet", "ArrayDataSet", "SampleDataSet",
           "DistributedDataSet", "PartitionStreamDataSet",
           "iter_process_batches", "process_world", "to_dataset"]
