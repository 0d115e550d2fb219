"""Serve a trained text classifier as a DataFrame UDF.

Counterpart of ``examples/udfpredict/udf_predict.py``: the text CNN of
``train_text_cnn`` trains with SGD (0.05) on news20 (``--data-dir``)
or the synthetic stand-in, then predicts in two forms: the UDF
(``make_predict_udf``: raw text in, 1-based class out, through
``optim/evaluator.py``'s ``predict``) over a column of texts, and
``DLClassifierModel.transform`` over a dict DataFrame of the encoded
rows.  The flags are the JAX example's, with ``--device`` added
(default the card):

    python -m bigdl_tpu_torch.examples.udf_predict --max-epoch 2
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from bigdl_tpu_torch.examples.train_text_cnn import (build_text_cnn,
                                                     encode_texts,
                                                     tokenize_corpus)

log = logging.getLogger("udfpredict")


def load_docs(data_dir=None):
    """(docs, n_classes): news20 from ``data_dir`` (an error when it is
    missing there), else from the default place, else the synthetic
    stand-in."""
    from bigdl_tpu_torch.dataset.news20 import (CLASS_NUM, get_news20,
                                                synthetic_news20)

    if data_dir:
        return get_news20(data_dir), CLASS_NUM
    try:
        return get_news20(), CLASS_NUM
    except FileNotFoundError:
        log.info("no news20 corpus on disk; using the synthetic stand-in")
        return synthetic_news20(1536, class_num=4), 4


def make_predict_udf(model, dictionary, doc_len, device="cuda"):
    """``predict(text) -> 1-based class id``, or on a list of texts an
    array of them (one batched ``predict`` for the whole column): the
    texts encoded by ``encode_texts`` with the training ``Dictionary``,
    the model's eval forward on ``device``, argmax + 1."""
    from bigdl_tpu_torch.optim.evaluator import predict

    def predict_udf(text_or_texts):
        single = isinstance(text_or_texts, str)
        texts = [text_or_texts] if single else list(text_or_texts)
        logp = predict(model, encode_texts(texts, dictionary, doc_len),
                       device=device)
        cls = logp.argmax(axis=-1) + 1
        return int(cls[0]) if single else cls

    return predict_udf


def main(argv=None):
    """Train, then predict the first 8 documents both ways; returns the
    UDF's accuracy on them."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--max-epoch", type=int, default=2)
    parser.add_argument("--doc-len", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from bigdl_tpu_torch.dlframes import DLClassifierModel
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    docs, n_classes = load_docs(args.data_dir)
    x, y, dic = tokenize_corpus(docs, args.doc_len)
    model = build_text_cnn(len(dic) + 1, n_classes=n_classes,
                           doc_len=args.doc_len, device=args.device)
    opt = Optimizer(model=model, training_set=(x, y),
                    criterion=ClassNLLCriterion(),
                    batch_size=args.batch_size, device=args.device)
    opt.set_optim_method(SGD(learningrate=0.05))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    model = opt.optimize()

    predict_udf = make_predict_udf(model, dic, args.doc_len, args.device)
    texts = [doc for doc, _ in docs[:8]]
    labels = [label for _, label in docs[:8]]
    preds = predict_udf(texts)
    for text, pred, label in zip(texts, preds, labels):
        log.info("pred=%d label=%d  %.60s", pred, label, text)
    acc = float(np.mean(np.asarray(preds) == np.asarray(labels)))
    log.info("UDF head accuracy on %d rows: %.2f", len(texts), acc)

    df = {"text": texts, "features": [row for row in x[:8]]}
    out = DLClassifierModel(model, feature_size=[args.doc_len],
                            device=args.device).transform(df)
    log.info("DLClassifierModel predictions: %s",
             [int(p) for p in out["prediction"]])
    return acc


if __name__ == "__main__":
    main()
