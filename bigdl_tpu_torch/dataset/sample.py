"""``Sample`` and ``MiniBatch``.

Counterpart of ``bigdl_tpu/dataset/sample.py`` (the whole module; the
reference's Sample.scala and MiniBatch.scala).  A ``Sample`` is one
(features, labels) record, host numpy; a ``MiniBatch`` is the stacked
batch a step takes.  Variable-length features are padded at batch time
(``samples_to_minibatch``), as the reference's FeaturePadding does for
the text pipelines.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Sample:
    """One (features, labels) record; ``features`` is one array or a
    list of arrays (a table input)."""

    def __init__(self, features, labels):
        # features: one array or a list of arrays (table input)
        if isinstance(features, (list, tuple)):
            self.features = [np.asarray(f) for f in features]
            self._multi = True
        else:
            self.features = np.asarray(features)
            self._multi = False
        self.labels = np.asarray(labels)

    @staticmethod
    def from_ndarray(features, labels):
        """The Python-BigDL spelling (``Sample.from_ndarray``)."""
        return Sample(features, labels)

    def feature(self):
        return self.features

    def label(self):
        return self.labels

    def __repr__(self):
        shape = (
            [f.shape for f in self.features] if self._multi
            else self.features.shape
        )
        return f"Sample(features={shape}, labels={self.labels.shape})"


class MiniBatch:
    """A stacked batch: ``input`` (an array or a tuple of arrays) and
    ``target``."""

    def __init__(self, input, target):
        self.input = input
        self.target = target

    def size(self) -> int:
        arr = self.input[0] if isinstance(self.input, (list, tuple)) \
            else self.input
        return arr.shape[0]

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target


def _pad_stack(arrays: Sequence[np.ndarray], padding_value: float = 0.0,
               fixed_length: Optional[int] = None):
    """Stack arrays, padding dim 0 to the max (or fixed) length when
    shapes differ (the reference's PaddingParam / FeaturePadding)."""
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and fixed_length is None:
        return np.stack(arrays)
    max_len = fixed_length or max(a.shape[0] for a in arrays)
    out_shape = (len(arrays), max_len) + arrays[0].shape[1:]
    out = np.full(out_shape, padding_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def samples_to_minibatch(samples: Sequence[Sample], padding_value: float = 0.0,
                         fixed_length: Optional[int] = None) -> MiniBatch:
    """Stack ``samples`` into one ``MiniBatch``, padding variable-length
    features (and labels) along dim 0."""
    first = samples[0]
    if first._multi:
        n_inputs = len(first.features)
        inputs = [
            _pad_stack([s.features[i] for s in samples], padding_value,
                       fixed_length)
            for i in range(n_inputs)
        ]
        inp = tuple(inputs)
    else:
        inp = _pad_stack([s.features for s in samples], padding_value,
                         fixed_length)
    tgt = _pad_stack([s.labels for s in samples], padding_value)
    return MiniBatch(inp, tgt)


__all__ = ["Sample", "MiniBatch", "samples_to_minibatch"]
