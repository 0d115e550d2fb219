"""NCF recommendation: implicit feedback, scored by HitRatio and NDCG.

Counterpart of ``examples/recommendation/ncf_train.py``: with no corpus
on disk it builds the synthetic latent-factor interactions
(``synthetic_interactions``, the same arrays as the JAX example's for
the same sizes), trains NeuralCF on positive and sampled-negative
pairs (``training_pairs``: 2-class ``ClassNLLCriterion``) with
``Adam``, and scores the leave-one-out protocol (``eval_ranking``:
each user's held-out positive ranked against 99 sampled negatives).
With ``-f DIR`` it reads ``DIR/ml-1m/ratings.dat`` instead (ratings of
4 or more are the positives).  The flags are the JAX example's, with
``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.ncf_train --n-users 6040 \\
        --n-items 3706 -e 1
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger("ncf")


def _group_positives(rows, min_per_user=5):
    """(N, 3) rating rows → the implicit positives (rating >= 4): one
    array of 0-based items per user with at least ``min_per_user``."""
    keep = rows[rows[:, 2] >= 4]
    order = np.argsort(keep[:, 0], kind="stable")
    _, starts = np.unique(keep[order, 0], return_index=True)
    items = keep[order, 1] - 1
    chunks = np.split(items, starts[1:])
    return [c for c in chunks if len(c) >= min_per_user]


def synthetic_interactions(n_users=200, n_items=400, dim=4, per_user=20,
                           seed=0):
    """Each user's ``per_user`` top-scoring items under
    ``latent_scores``: a (n_users, per_user) array of 0-based items."""
    from bigdl_tpu_torch.dataset.movielens import latent_scores

    scores = latent_scores(n_users, n_items, dim, seed)
    return np.argsort(-scores, axis=1)[:, :per_user]


def movielens_interactions(data_dir, min_per_user=5):
    """(positives, n_users, n_items) of ``data_dir``'s ml-1m ratings."""
    from bigdl_tpu_torch.dataset.movielens import get_id_ratings

    rows = get_id_ratings(data_dir)
    pos = _group_positives(rows, min_per_user)
    return pos, len(pos), int(rows[:, 1].max())


def training_pairs(pos, n_items, neg_per_pos=4, seed=1):
    """(x, y): 1-based (user, item) rows as float32, label 2 for a
    positive and 1 for each of its ``neg_per_pos`` sampled negatives;
    each user's item 0 is held out for ``eval_ranking``."""
    rs = np.random.RandomState(seed)
    users, items, labels = [], [], []
    pos_sets = [set(row) for row in pos]
    for uid, row in enumerate(pos):
        for it in row[1:]:
            users.append(uid)
            items.append(it)
            labels.append(2)
            for _ in range(neg_per_pos):
                j = rs.randint(n_items)
                while j in pos_sets[uid]:
                    j = rs.randint(n_items)
                users.append(uid)
                items.append(j)
                labels.append(1)
    x = np.stack([np.asarray(users) + 1.0, np.asarray(items) + 1.0], 1)
    return x.astype(np.float32), np.asarray(labels, np.float32)


def ranking_candidates(pos, n_items, neg_num=99, seed=2):
    """The (users × (1 + neg_num), 2) float32 rows ``eval_ranking``
    scores: each user's held-out positive, then ``neg_num`` sampled
    items the user never interacted with."""
    rs = np.random.RandomState(seed)
    pos_sets = [set(row) for row in pos]
    rows = []
    for uid, row in enumerate(pos):
        cands = [row[0]]
        while len(cands) < neg_num + 1:
            j = rs.randint(n_items)
            if j not in pos_sets[uid]:
                cands.append(j)
        for it in cands:
            rows.append((uid + 1, it + 1))
    return np.asarray(rows, np.float32)


def eval_ranking(model, pos, n_items, neg_num=99, k=10, seed=2,
                 device="cuda"):
    """(HitRatio@k, NDCG@k) of the leave-one-out protocol, the score of
    a row being its log P(interacted)."""
    from bigdl_tpu_torch.optim import NDCG, HitRatio
    from bigdl_tpu_torch.optim.evaluator import predict

    x = ranking_candidates(pos, n_items, neg_num, seed)
    scores = predict(model, x, batch_size=1000, device=device)[:, 1]
    hr = HitRatio(k=k, neg_num=neg_num).batch_result(scores, None)
    ndcg = NDCG(k=k, neg_num=neg_num).batch_result(scores, None)
    return hr.result()[0], ndcg.result()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--data-dir", default=None,
                    help="dir containing ml-1m/ratings.dat (else a "
                         "synthetic latent-factor corpus)")
    ap.add_argument("-b", "--batch-size", type=int, default=256)
    ap.add_argument("-e", "--max-epoch", type=int, default=4)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--n-users", type=int, default=200)
    ap.add_argument("--n-items", type=int, default=400)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from bigdl_tpu_torch.models.ncf import build_ncf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    if args.data_dir:
        pos, n_users, n_items = movielens_interactions(args.data_dir)
        log.info("MovieLens: %d users, %d items", n_users, n_items)
    else:
        pos = synthetic_interactions(args.n_users, args.n_items)
        n_users, n_items = args.n_users, args.n_items
    x, y = training_pairs(pos, n_items)
    model = build_ncf(n_users, n_items, class_num=2, device=args.device)
    opt = Optimizer(model=model, training_set=(x, y),
                    criterion=ClassNLLCriterion(),
                    batch_size=args.batch_size, device=args.device)
    opt.set_optim_method(Adam(learningrate=args.learning_rate))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    model = opt.optimize()
    hr, ndcg = eval_ranking(model, pos, n_items, device=args.device)
    log.info("HitRatio@10: %.3f   NDCG@10: %.3f  (random ~ 0.10 / 0.045)",
             hr, ndcg)
    return hr, ndcg


if __name__ == "__main__":
    main()
