"""MovieLens ratings, and the synthetic latent-factor stand-in.

Counterpart of ``bigdl_tpu/dataset/movielens.py``: ``get_id_ratings``
(:24) reads an ``ml-1m`` directory already on disk (``ratings.dat``
with ``::``-separated fields, or ``ml-1m.zip`` beside it) and never
downloads; ``latent_scores`` (:47) and ``synthetic_movielens`` (:56)
give the same arrays as the JAX package's for the same seeds (the same
``numpy.random.RandomState`` draws in the same order).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

MOVIELENS_1M_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"


def get_id_ratings(source_dir: str) -> np.ndarray:
    """(N, 3) int32 array of 1-based (user, item, rating) rows from
    ``source_dir/ml-1m/ratings.dat`` (extracted from
    ``source_dir/ml-1m.zip`` when only the zip is there)."""
    ratings = os.path.join(source_dir, "ml-1m", "ratings.dat")
    if not os.path.exists(ratings):
        zpath = os.path.join(source_dir, "ml-1m.zip")
        if os.path.exists(zpath):
            with zipfile.ZipFile(zpath) as z:
                z.extractall(source_dir)
        if not os.path.exists(ratings):
            raise FileNotFoundError(
                f"no MovieLens data under {source_dir}: put ml-1m/"
                f"ratings.dat (from {MOVIELENS_1M_URL}) there first")
    rows = []
    with open(ratings, encoding="latin-1") as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) >= 3:
                rows.append((int(parts[0]), int(parts[1]), int(parts[2])))
    return np.asarray(rows, dtype=np.int32)


def latent_scores(n_users: int, n_items: int, dim: int = 4,
                  seed: int = 0) -> np.ndarray:
    """The hidden user × item affinity of the synthetic corpora: the
    product of two standard normal factor matrices."""
    rs = np.random.RandomState(seed)
    return rs.randn(n_users, dim) @ rs.randn(n_items, dim).T


def synthetic_movielens(n_users: int = 200, n_items: int = 400,
                        per_user: int = 25, dim: int = 4,
                        seed: int = 0) -> np.ndarray:
    """(N, 3) ratings 1-5: ``per_user`` items a user, each rated by the
    global quintile of its latent score."""
    rs = np.random.RandomState(seed + 1)
    all_scores = latent_scores(n_users, n_items, dim, seed)
    cuts = np.quantile(all_scores, [0.2, 0.4, 0.6, 0.8])
    rows = []
    for uid in range(n_users):
        items = rs.choice(n_items, size=per_user, replace=False)
        rating = 1 + np.searchsorted(cuts, all_scores[uid, items])
        for it, r in zip(items, rating):
            rows.append((uid + 1, it + 1, int(np.clip(r, 1, 5))))
    return np.asarray(rows, dtype=np.int32)


__all__ = ["MOVIELENS_1M_URL", "get_id_ratings", "latent_scores",
           "synthetic_movielens"]
