"""The 20-Newsgroups corpus and GloVe vectors, and their stand-ins.

Counterpart of ``bigdl_tpu/dataset/news20.py``: ``get_news20`` (:29)
reads an extracted ``20news-18828`` tree (or its tarball) from
``source_dir``, ``get_glove_w2v`` (:81) a ``glove.6B.<dim>d.txt``;
neither downloads (they raise with the URL).  ``synthetic_news20``
(:101) and ``synthetic_glove`` (:118) are the same deterministic
stand-ins, copied so that the port draws the same documents from the
same seed without importing the JAX package.  ``synthetic_glove`` seeds
each word from Python's ``hash(w)``, as the JAX function does, so its
vectors agree between the packages within one process and change from
process to process unless ``PYTHONHASHSEED`` is set.

The default ``source_dir`` is ``news20/`` under the temporary directory
(``tempfile.gettempdir()``, ``/tmp`` unless ``TMPDIR`` says otherwise),
where the JAX package reads ``/tmp/news20/``.
"""

from __future__ import annotations

import os
import tarfile
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

NEWS20_URL = "http://qwone.com/~jason/20Newsgroups/20news-18828.tar.gz"
GLOVE_URL = "http://nlp.stanford.edu/data/glove.6B.zip"

CLASS_NUM = 20


def _default_dir(*parts) -> str:
    return os.path.join(tempfile.gettempdir(), "news20", *parts)


def _looks_like_corpus(cand: str) -> bool:
    """The extracted tree: at least two per-newsgroup dirs with dotted
    names (alt.atheism, sci.space, ...), at least half of the subdirs,
    so that an unrelated sibling (glove.6B/) does not match."""
    if not os.path.isdir(cand):
        return False
    subdirs = [d for d in os.listdir(cand)
               if os.path.isdir(os.path.join(cand, d))]
    dotted = [d for d in subdirs if "." in d]
    return len(dotted) >= 2 and len(dotted) >= len(subdirs) / 2


def get_news20(source_dir: Optional[str] = None) -> List[Tuple[str, int]]:
    """[(text, 1-based label)], the labels in the sorted order of the
    newsgroup dirs, each post decoded as latin-1."""
    source_dir = source_dir or _default_dir()
    root = None
    for cand in (os.path.join(source_dir, "20news-18828"), source_dir):
        if _looks_like_corpus(cand):
            root = cand
            break
    if root is None:
        tar = os.path.join(source_dir, "20news-18828.tar.gz")
        if os.path.exists(tar):
            with tarfile.open(tar, "r:gz") as tf:
                tf.extractall(source_dir, filter="data")
            root = os.path.join(source_dir, "20news-18828")
    if root is None or not os.path.isdir(root):
        raise FileNotFoundError(
            f"no 20-Newsgroups data under {source_dir!r}; download "
            f"{NEWS20_URL} there first")
    texts = []
    groups = sorted(d for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d)) and "." in d)
    for label, group in enumerate(groups, start=1):
        gdir = os.path.join(root, group)
        for fname in sorted(os.listdir(gdir)):
            try:
                with open(os.path.join(gdir, fname), "rb") as f:
                    texts.append((f.read().decode("latin-1"), label))
            except OSError:
                continue
    return texts


def get_glove_w2v(source_dir: Optional[str] = None,
                  dim: int = 100) -> Dict[str, np.ndarray]:
    """{word: f32 vector} from ``glove.6B.<dim>d.txt`` in
    ``source_dir``."""
    path = os.path.join(source_dir or _default_dir("glove.6B"),
                        f"glove.6B.{dim}d.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; download {GLOVE_URL} and unzip there")
    w2v = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w2v[parts[0]] = np.asarray(parts[1:], np.float32)
    return w2v


_SYNTH_TOPIC_WORDS = 12  # per-class vocabulary block


def synthetic_news20(n: int = 400, seed: int = 7,
                     class_num: int = CLASS_NUM) -> List[Tuple[str, int]]:
    """n documents of 30 words, class ``i % class_num + 1``: each word
    from the class's block ``word{c·12}..word{c·12+11}`` with
    probability 0.7, else one of 20 shared ``common`` words."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        label = i % class_num + 1
        base = (label - 1) * _SYNTH_TOPIC_WORDS
        words = []
        for _ in range(30):
            if rs.rand() < 0.7:
                words.append(f"word{base + rs.randint(_SYNTH_TOPIC_WORDS)}")
            else:
                words.append(f"common{rs.randint(20)}")
        out.append((" ".join(words), label))
    return out


def synthetic_glove(vocab: List[str], dim: int = 50,
                    seed: int = 11) -> Dict[str, np.ndarray]:
    """A 0.1-scaled normal vector per word, seeded from ``hash(w) ^
    seed`` (so one word maps to one vector within a process)."""
    out = {}
    for w in vocab:
        h = (hash(w) ^ seed) % (2 ** 31)
        out[w] = np.random.RandomState(h).randn(dim).astype(np.float32) * 0.1
    return out


__all__ = ["CLASS_NUM", "NEWS20_URL", "GLOVE_URL", "get_news20",
           "get_glove_w2v", "synthetic_news20", "synthetic_glove"]
