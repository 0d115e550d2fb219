"""Wide & Deep (counterpart of ``bigdl_tpu/models/wide_and_deep.py``).

One packed f32 matrix a batch, JAX's fixed-slot layout:

    x = [wide_ids (S_w) | wide_weights (S_w) | deep_ids (n_deep)]

The wide term ``Σ w[id]·weight`` is ``LookupTableSparse``'s padded
path with ``n_output = class_num``; each deep column has its own
``LookupTable``, concatenated into an MLP; the two towers are summed
before ``LogSoftMax``.  The ids ride as floats, exact only below 2**24
(``pack_batch`` refuses more), and a bf16 forward would round ids above
256: the model trains in f32 (a hazard JAX shares).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bigdl_tpu_torch.nn import (CAddTable, Graph, Input, JoinTable, Linear,
                                LogSoftMax, LookupTable, LookupTableSparse,
                                Narrow, ReLU, Reshape)


def build_wide_and_deep(wide_vocab: int, deep_vocabs: Sequence[int],
                        class_num: int = 2, wide_slots: int = 8,
                        embed_dim: int = 8,
                        hidden_layers: Sequence[int] = (32, 16)):
    """The Wide & Deep graph over the packed input (JAX :44): x (B, 2 ·
    wide_slots + len(deep_vocabs)) f32."""
    n_deep = len(deep_vocabs)
    inp = Input()
    wide_ids = Narrow(2, 1, wide_slots)(inp)
    wide_wts = Narrow(2, wide_slots + 1, wide_slots)(inp)
    wide_out = LookupTableSparse(wide_vocab, class_num, combiner="sum")(
        wide_ids, wide_wts)
    embeds = []
    for c, vocab in enumerate(deep_vocabs):
        ids_c = Narrow(2, 2 * wide_slots + c + 1, 1)(inp)
        embeds.append(LookupTable(vocab, embed_dim)(ids_c))   # (B, 1, D)
    h = JoinTable(2, 3)(*embeds) if n_deep > 1 else embeds[0]
    h = Reshape([n_deep * embed_dim], batch_mode=True)(h)
    width = n_deep * embed_dim
    for n in hidden_layers:
        h = ReLU()(Linear(width, n)(h))
        width = n
    deep_out = Linear(width, class_num)(h)
    out = LogSoftMax()(CAddTable()(wide_out, deep_out))
    return Graph([inp], [out])


def pack_batch(wide_sparse, deep_ids, wide_slots: int) -> np.ndarray:
    """COO wide features and (B, n_deep) deep ids -> the packed f32
    matrix ``build_wide_and_deep`` reads (JAX :87).  f32 holds integers
    exactly only below 2**24: an id at or above it is refused, not
    rounded onto a neighbouring embedding row."""
    ids, wts = wide_sparse.to_padded(wide_slots)
    deep = np.asarray(deep_ids)
    limit = 1 << 24
    if ids.max(initial=0) >= limit or deep.max(initial=0) >= limit:
        raise ValueError(
            "pack_batch: ids >= 2**24 do not survive the float32 packed "
            "encoding; hash/bucket the vocab below 16.7M first")
    return np.concatenate(
        [ids.astype(np.float32), wts, deep.astype(np.float32)], axis=1
    ).astype(np.float32)


__all__ = ["build_wide_and_deep", "pack_batch"]
