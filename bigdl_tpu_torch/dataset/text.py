"""Text pipeline: ``Dictionary``, ``LabeledSentence`` and the PTB
BPTT batcher, numpy only.

Counterpart of ``bigdl_tpu/dataset/text.py``: ``Dictionary`` (:17),
``LabeledSentence`` (:54), ``ptb_bptt_batches`` (:63) and
``synthetic_ptb_stream`` (:81), copied so that the port draws the same
stream and windows from the same seed without importing the JAX
package.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional, Sequence

import numpy as np


class Dictionary:
    """«bigdl»/dataset/text/Dictionary.scala — vocab with 1-based ids
    (id 0 is reserved so embeddings stay 1-based like LookupTable)."""

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self._word2idx = {}
        self._idx2word = []
        if sentences is not None:
            counts = Counter()
            for s in sentences:
                counts.update(s)
            vocab = [w for w, _ in counts.most_common(vocab_size)]
            for w in vocab:
                self.add_word(w)

    def add_word(self, word: str) -> int:
        if word not in self._word2idx:
            self._idx2word.append(word)
            self._word2idx[word] = len(self._idx2word)  # 1-based
        return self._word2idx[word]

    def get_index(self, word: str, default: Optional[int] = None) -> int:
        if default is None:
            default = len(self._idx2word)  # last id as <unk> bucket
        return self._word2idx.get(word, default)

    def get_word(self, index: int) -> str:
        return self._idx2word[index - 1]

    def vocab_size(self) -> int:
        return len(self._idx2word)

    def __len__(self):
        return len(self._idx2word)


class LabeledSentence:
    """«bigdl»/dataset/text/LabeledSentence.scala — token ids + per-token
    labels (for LM: labels are the ids shifted by one)."""

    def __init__(self, data: Sequence[float], labels: Sequence[float]):
        self.data = np.asarray(data, np.float32)
        self.labels = np.asarray(labels, np.float32)


def ptb_bptt_batches(token_ids: np.ndarray, batch_size: int, num_steps: int):
    """The PTB LM batcher (reference: models/rnn data prep): reshape the
    token stream into batch_size parallel streams, then slice fixed
    num_steps windows; x = tokens[t], y = tokens[t+1].  Returns arrays
    (n_batches, batch_size, num_steps)."""
    ids = np.asarray(token_ids, np.float32)
    n = (len(ids) - 1) // (batch_size * num_steps) * batch_size * num_steps
    if n <= 0:
        raise ValueError("token stream too short for one batch")
    x = ids[:n].reshape(batch_size, -1)
    y = ids[1 : n + 1].reshape(batch_size, -1)
    n_windows = x.shape[1] // num_steps
    shape = (batch_size, n_windows, num_steps)
    xs = x[:, : n_windows * num_steps].reshape(shape)
    ys = y[:, : n_windows * num_steps].reshape(shape)
    return (np.transpose(xs, (1, 0, 2)).copy(),
            np.transpose(ys, (1, 0, 2)).copy())


def synthetic_ptb_stream(n_tokens: int = 20000, vocab_size: int = 100,
                         seed: int = 0, order: int = 2) -> np.ndarray:
    """Deterministic synthetic token stream with learnable Markov
    structure (no network access; same role as mnist.synthetic_mnist):
    1-based ids."""
    rng = np.random.RandomState(seed)
    # a sparse deterministic-ish transition table
    table = rng.randint(1, vocab_size + 1, size=(vocab_size, 4))
    out = np.empty(n_tokens, np.int64)
    out[0] = 1
    for i in range(1, n_tokens):
        prev = out[i - 1] - 1
        # 80% follow the table, 20% noise — learnable but not trivial
        if rng.rand() < 0.8:
            out[i] = table[prev, rng.randint(4)]
        else:
            out[i] = rng.randint(1, vocab_size + 1)
    return out


__all__ = ["Dictionary", "LabeledSentence", "ptb_bptt_batches",
           "synthetic_ptb_stream"]
