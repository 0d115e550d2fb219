"""``DLClassifier`` in an ML-pipeline flow: a DataFrame in, one out.

Counterpart of ``examples/dlframes/dl_classifier_example.py``: fit a
small MLP (6 -> 32 -> 2) on a DataFrame of (features, label) columns
(pandas when installed, else a dict of columns) for 5 epochs at batch
64, then ``transform`` adds a prediction column; it prints and returns
the train accuracy.  The JAX example takes no flags; ``--device`` is
added (default the card):

    python -m bigdl_tpu_torch.examples.dl_classifier_example
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def main(argv=None):
    """Fit and transform as the JAX example does; returns the train
    accuracy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from bigdl_tpu_torch.dlframes import DLClassifier
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                    ReLU, Sequential)

    rs = np.random.RandomState(0)
    n = 1024
    x = rs.randn(n, 6).astype(np.float32)
    # two interleaved classes, 1-based labels
    y = (1 + ((x[:, 0] + x[:, 1] * 0.5 + 0.1 * rs.randn(n)) > 0)).astype(
        np.float32)
    try:
        import pandas as pd

        df = pd.DataFrame({"features": list(x), "label": y})
    except ImportError:
        df = {"features": x, "label": y}

    model = Sequential().add(Linear(6, 32)).add(ReLU()) \
        .add(Linear(32, 2)).add(LogSoftMax())
    clf = DLClassifier(model, ClassNLLCriterion(), [6], device=args.device) \
        .set_batch_size(64).set_max_epoch(5).set_learning_rate(0.1)
    fitted = clf.fit(df)
    out = fitted.transform(df)
    pred = np.asarray(
        out["prediction"] if isinstance(out, dict)
        else out["prediction"].tolist())
    acc = float((pred.reshape(-1) == y).mean())
    print(f"train accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
