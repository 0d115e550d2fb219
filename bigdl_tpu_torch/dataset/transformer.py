"""Transformer combinators over record iterators.

Counterpart of ``bigdl_tpu/dataset/transformer.py`` (the whole module;
the reference's Transformer.scala): composable iterator -> iterator
stages, chained with ``>>`` where the reference writes ``->``.
``SampleToMiniBatch`` is the one a training pipeline ends in.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.dataset.sample import Sample, samples_to_minibatch


class Transformer:
    """An iterator -> iterator stage; ``a >> b`` (or ``a.chain(b)``)
    runs ``a`` then ``b``."""

    def __call__(self, iterator: Iterator) -> Iterator:
        raise NotImplementedError

    def chain(self, other: "Transformer") -> "Transformer":
        return _Chained(self, other)

    def __rshift__(self, other):
        return self.chain(other)


class _Chained(Transformer):
    def __init__(self, first, second):
        self.first, self.second = first, second

    def __call__(self, iterator):
        return self.second(self.first(iterator))


class SampleToMiniBatch(Transformer):
    """Group Samples into padded MiniBatches, yielding (input, target)
    pairs; a short last batch is dropped unless ``drop_last=False``."""

    def __init__(self, batch_size: int, padding_value: float = 0.0,
                 fixed_length: Optional[int] = None, drop_last: bool = True):
        self.batch_size = batch_size
        self.padding_value = padding_value
        self.fixed_length = fixed_length
        self.drop_last = drop_last

    def __call__(self, iterator):
        buf = []
        for s in iterator:
            buf.append(s)
            if len(buf) == self.batch_size:
                mb = samples_to_minibatch(buf, self.padding_value, self.fixed_length)
                yield mb.input, mb.target
                buf = []
        if buf and not self.drop_last:
            mb = samples_to_minibatch(buf, self.padding_value, self.fixed_length)
            yield mb.input, mb.target


class Shuffle(Transformer):
    """Buffer every item, then yield them in a permutation drawn from
    ``RandomGenerator.RNG`` (the reference shuffles at the RDD
    level)."""

    def __call__(self, iterator):
        items = list(iterator)
        for i in RandomGenerator.RNG.randperm(len(items)):
            yield items[i]


class Normalizer(Transformer):
    """``(x - mean) / std`` over each Sample's features (the reference's
    GreyImgNormalizer)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def __call__(self, iterator):
        for s in iterator:
            yield Sample((np.asarray(s.features) - self.mean) / self.std, s.labels)


__all__ = ["Transformer", "SampleToMiniBatch", "Shuffle", "Normalizer"]
