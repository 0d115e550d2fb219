"""Keras-API MNIST CNN.

Counterpart of ``examples/keras/mnist_cnn.py``: the
``bigdl_tpu_torch.keras`` ``Sequential`` builds a small CNN (two 3x3
convs with ReLU and 2x2 max pools, a 64-wide Dense, Dropout, a
10-way softmax Dense), and ``compile("adam", "categorical_crossentropy")``
/ ``fit`` / ``evaluate`` train it on all but the first 256 images and
score it on those.  With no MNIST on disk the deterministic synthetic
digits stand in.  The flags are the JAX example's, with ``--device``
added (default the card):

    python -m bigdl_tpu_torch.examples.mnist_cnn --nb-epoch 2
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger("keras_mnist")


def main(argv=None):
    """Train and score as the JAX example does; returns the held-out
    (loss, accuracy)."""
    from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
    from bigdl_tpu_torch.keras.layers import (Convolution2D, Dense, Dropout,
                                              Flatten, MaxPooling2D)
    from bigdl_tpu_torch.keras.models import Sequential

    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--data-dir", default=None)
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("--nb-epoch", type=int, default=2)
    ap.add_argument("-n", "--num-samples", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    x, y = load_mnist(args.data_dir, "train", synthetic_n=args.num_samples)
    x = normalize(x).reshape(-1, 1, 28, 28)

    model = Sequential(device=args.device)
    model.add(Convolution2D(16, 3, 3, activation="relu",
                            input_shape=(1, 28, 28)))
    model.add(MaxPooling2D((2, 2)))
    model.add(Convolution2D(32, 3, 3, activation="relu"))
    model.add(MaxPooling2D((2, 2)))
    model.add(Flatten())
    model.add(Dense(64, activation="relu"))
    model.add(Dropout(0.25))
    model.add(Dense(10, activation="softmax"))
    log.info("\n%s", model.summary())

    model.compile(optimizer="adam", loss="categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x[256:], y[256:], batch_size=args.batch_size,
              nb_epoch=args.nb_epoch)
    loss, acc = model.evaluate(x[:256], y[:256],
                               batch_size=args.batch_size)
    log.info("held-out loss %.4f accuracy %.4f", loss, acc)
    return loss, acc


if __name__ == "__main__":
    main()
