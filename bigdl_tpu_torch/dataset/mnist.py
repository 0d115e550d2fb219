"""MNIST: the idx readers, the synthetic stand-in and the normalizer,
numpy only.

Counterpart of ``bigdl_tpu/dataset/mnist.py``: ``_read_idx_images``
(:22), ``_read_idx_labels`` (:30), ``synthetic_mnist`` (:38),
``load_mnist`` (:55) and ``normalize`` (:76), copied so that the port
reads the same files, or synthesizes the same task from the same seeds,
without importing the JAX package.  With no idx files under
``data_dir``, ``load_mnist`` returns the synthetic task: class templates
plus noise, learnable to Top1 >= 0.99 in two LeNet-5 epochs.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255


def _read_idx_images(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8)


def synthetic_mnist(n: int, seed: int = 42, n_classes: int = 10,
                    image_size: int = 28, template_seed: int = 1234):
    """Deterministic learnable stand-in: each class is a fixed random
    template plus Gaussian noise.  The templates come from a *fixed*
    ``template_seed`` shared by every split (train/test must share the
    class structure or validation is unlearnable); ``seed`` only drives
    the sampling + noise.  Returns (images[n,28,28] float in 0..255-ish
    scale, labels[n] 1-based)."""
    trng = np.random.RandomState(template_seed)
    templates = trng.uniform(0, 255, size=(n_classes, image_size, image_size))
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n)
    images = templates[labels] + rng.normal(
        0, 32.0, size=(n, image_size, image_size))
    images = np.clip(images, 0, 255).astype(np.float32)
    return images, (labels + 1).astype(np.float32)  # 1-based labels


def load_mnist(data_dir: str = None, subset: str = "train",
               synthetic_n: int = 2048):
    """Returns (images [N, 28, 28] float32 raw 0-255, labels [N] 1-based
    float32).  Looks for idx(.gz) files under ``data_dir``; synthesizes
    when absent."""
    names = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }[subset]
    if data_dir:
        for ext in ("", ".gz"):
            img_p = os.path.join(data_dir, names[0] + ext)
            lbl_p = os.path.join(data_dir, names[1] + ext)
            if os.path.exists(img_p) and os.path.exists(lbl_p):
                images = _read_idx_images(img_p).astype(np.float32)
                labels = _read_idx_labels(lbl_p).astype(np.float32) + 1.0
                return images, labels
    seed = 42 if subset == "train" else 43
    return synthetic_mnist(synthetic_n, seed=seed)


def normalize(images: np.ndarray) -> np.ndarray:
    """Reference: GreyImgNormalizer(trainMean, trainStd)."""
    return (images - TRAIN_MEAN) / TRAIN_STD


__all__ = ["TRAIN_MEAN", "TRAIN_STD", "synthetic_mnist", "load_mnist",
           "normalize"]
