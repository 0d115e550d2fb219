"""Text classification: an embedding and a temporal CNN.

Counterpart of ``examples/textclassification/train_text_cnn.py``: the
corpus (``get_news20`` from ``-f DIR``, else the synthetic keyword task
``synthetic_news20(1536, class_num=4)``) goes through the
``Dictionary`` into padded 1-based id rows (``tokenize_corpus``,
``encode_texts``), and ``build_text_cnn``'s ``LookupTable ->
TemporalConvolution -> ReLU -> Max(2) -> Linear -> LogSoftMax`` trains
with ``Adam`` and ``ClassNLLCriterion`` through the ``Optimizer``
factory (a ``LocalOptimizer``), with Top-1 validation on the last
eighth (at least 64 rows) every epoch.  The flags are the JAX
example's, with ``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.train_text_cnn -b 128 -e 3 \\
        --learning-rate 0.05 --doc-len 32
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger("textclassification")


def build_text_cnn(vocab, embed=32, n_classes=4, doc_len=32, device="cuda"):
    """(B, doc_len) ids -> (B, n_classes) log-probabilities: 64 filters
    of width 5, a global max over time; weights drawn from
    ``RandomGenerator.RNG`` in JAX's order, then moved to ``device``."""
    from bigdl_tpu_torch.common import resolve_device
    from bigdl_tpu_torch.nn import (Linear, LogSoftMax, LookupTable, Max,
                                    ReLU, Sequential, TemporalConvolution)

    dev = resolve_device(device)
    return (Sequential()
            .add(LookupTable(vocab, embed))           # (B, T) -> (B, T, E)
            .add(TemporalConvolution(embed, 64, 5))   # (B, T-4, 64)
            .add(ReLU())
            .add(Max(2))                              # global max over time
            .add(Linear(64, n_classes))
            .add(LogSoftMax())).to(dev)


def encode_texts(texts, dic, doc_len):
    """Raw texts -> (N, doc_len) float32 ids: each lower-cased token's
    ``dic.get_index(tok, 0) + 1``, 0 past a text's end.  Training and
    serving (``udf_predict``) share this one encoding."""
    x = np.zeros((len(texts), doc_len), np.float32)
    for i, text in enumerate(texts):
        for j, tok in enumerate(text.lower().split()[:doc_len]):
            x[i, j] = dic.get_index(tok, 0) + 1
    return x


def tokenize_corpus(docs, doc_len=128, vocab_limit=20000):
    """[(text, label)] -> (ids, float32 labels, the ``Dictionary`` of the
    ``vocab_limit`` most frequent tokens)."""
    from bigdl_tpu_torch.dataset.text import Dictionary

    dic = Dictionary([d.lower().split() for d, _ in docs],
                     vocab_size=vocab_limit)
    x = encode_texts([d for d, _ in docs], dic, doc_len)
    y = np.asarray([label for _, label in docs], np.float32)
    return x, y, dic


def load_corpus(data_dir=None, doc_len=128):
    """(x, y, vocab, n_classes): news20 from disk when there is one,
    else the synthetic stand-in (4 classes)."""
    from bigdl_tpu_torch.dataset.news20 import (CLASS_NUM, get_news20,
                                                synthetic_news20)

    try:
        docs = get_news20(data_dir) if data_dir else get_news20()
        n_classes = CLASS_NUM
    except FileNotFoundError:
        log.info("no news20 corpus on disk; using the synthetic stand-in")
        docs = synthetic_news20(1536, class_num=4)
        n_classes = 4
    x, y, dic = tokenize_corpus(docs, doc_len)
    return x, y, len(dic) + 1, n_classes


def main(argv=None, train_summary=None, val_summary=None):
    """Train as the JAX example does; ``train_summary``/``val_summary``
    (``add_scalar`` objects), when given, go to the trainer.  Returns
    the trainer (its ``model`` the trained model)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-e", "--max-epoch", type=int, default=3)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("-f", "--data-dir", default=None,
                    help="dir containing 20news-18828 (else synthetic)")
    ap.add_argument("--doc-len", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, Optimizer, Top1Accuracy, Trigger

    x, y, vocab, n_classes = load_corpus(args.data_dir, args.doc_len)
    perm = np.random.RandomState(0).permutation(len(x))
    x, y = x[perm], y[perm]
    n_val = max(64, len(x) // 8)
    model = build_text_cnn(vocab=vocab, n_classes=n_classes,
                           doc_len=args.doc_len, device=args.device)
    optimizer = Optimizer(model=model, training_set=(x[:-n_val], y[:-n_val]),
                          criterion=ClassNLLCriterion(),
                          batch_size=args.batch_size, distributed=False,
                          device=args.device)
    optimizer.set_optim_method(Adam(learningrate=args.learning_rate)) \
        .set_end_when(Trigger.max_epoch(args.max_epoch)) \
        .set_validation(trigger=Trigger.every_epoch(),
                        dataset=(x[-n_val:], y[-n_val:]),
                        methods=[Top1Accuracy()])
    if train_summary is not None:
        optimizer.set_train_summary(train_summary)
    if val_summary is not None:
        optimizer.set_val_summary(val_summary)
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()
