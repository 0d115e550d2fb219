"""Wide & Deep recommendation: sparse cross features and deep
embeddings.

Counterpart of ``examples/recommendation/wide_and_deep_train.py``: with
no corpus on disk it builds the JAX example's synthetic tabular set
(``synthetic_tabular``, the same arrays for the same arguments): each
sample has a few active wide cross features (COO, packed to the
fixed-slot encoding by ``pack_batch``) and categorical deep columns;
the label mixes a memorization signal (a wide cross) with a
generalization one (a deep column).  It trains
``build_wide_and_deep`` with SGD through ``LocalOptimizer``, or with
``--distributed`` through ``DistriOptimizer`` over the ``Engine``'s
world, and reports the train-set Top1 accuracy.  The flags are the
JAX example's, with ``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.wide_and_deep_train -e 20
    python -m bigdl_tpu_torch.examples.wide_and_deep_train --distributed
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger("wide_and_deep")


def synthetic_tabular(n=4096, wide_vocab=200, deep_vocabs=(12, 20, 8),
                      wide_active=4, seed=0):
    """(COO wide features, (n, n_deep) 1-based deep ids, labels 1/2)."""
    from bigdl_tpu_torch.nn import SparseTensor

    rs = np.random.RandomState(seed)
    cols = rs.randint(0, wide_vocab, (n, wide_active))
    rows = np.repeat(np.arange(n), wide_active)
    sp = SparseTensor(np.stack([rows, cols.reshape(-1)], 1),
                      np.ones(n * wide_active, np.float32), (n, wide_vocab))
    deep = np.stack([rs.randint(1, v + 1, n) for v in deep_vocabs], axis=1)
    # label: wide memorization OR deep generalization
    y = (((cols[:, 0] > wide_vocab // 2).astype(int)
          | (deep[:, 0] > deep_vocabs[0] // 2).astype(int)) + 1
         ).astype(np.float32)
    return sp, deep, y


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("-e", "--max-epoch", type=int, default=20)
    p.add_argument("--learning-rate", type=float, default=1.0)
    p.add_argument("--wide-vocab", type=int, default=200)
    p.add_argument("--wide-slots", type=int, default=8)
    p.add_argument("--distributed", action="store_true",
                   help="DistriOptimizer over the Engine's world")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.models import build_wide_and_deep, pack_batch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.evaluator import evaluate_dataset

    deep_vocabs = (12, 20, 8)
    sp, deep, y = synthetic_tabular(wide_vocab=args.wide_vocab,
                                    deep_vocabs=deep_vocabs)
    x = pack_batch(sp, deep, args.wide_slots)
    model = build_wide_and_deep(args.wide_vocab, deep_vocabs, class_num=2,
                                wide_slots=args.wide_slots)
    if args.distributed:
        from bigdl_tpu_torch.engine import Engine
        from bigdl_tpu_torch.optim import DistriOptimizer

        Engine.init(args.device)
        opt = DistriOptimizer(model, (x, y), ClassNLLCriterion(),
                              batch_size=args.batch_size,
                              device=args.device)
    else:
        from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

        opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(),
                             batch_size=args.batch_size, device=args.device)
    opt.set_optim_method(SGD(learningrate=args.learning_rate))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    trained = opt.optimize()
    (acc,) = evaluate_dataset(trained, ArrayDataSet(x, y, args.batch_size),
                              [Top1Accuracy()], device=args.device)
    value, _ = acc.result()
    log.info("train-set Top1Accuracy: %.4f", value)
    return value


if __name__ == "__main__":
    main()
