"""An ImageNet-style directory of images, decoded on the host.

Counterpart of ``bigdl_tpu/dataset/imagenet.py``: ``scan_image_folder``
(:42), ``_decode`` (:62) and ``ImageFolderDataSet`` (:97).  The file
list is the partition table: every process draws the same seeded epoch
permutation and decodes only its own contiguous slice of each global
batch (``iter_process_batches``), so the card only ever sees fixed-shape
(B, C, H, W) float batches.  The trainers decode on their prefetch
thread (``dataset/prefetch.py``), off the step's path.

Layout (what an extracted ImageNet looks like):

    root/train/<wnid>/*.JPEG
    root/val/<wnid>/*.JPEG

Labels are 1-based indices into the sorted class names.  Without
Pillow only ``.bmp`` files decode (``transform/vision.py``); anything
else raises rather than train on stand-in pixels.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.dataset import (DataSet, iter_process_batches,
                                             process_world)

_IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def scan_image_folder(split_dir: str
                      ) -> Tuple[List[str], np.ndarray, List[str]]:
    """(paths, 1-based f32 labels, sorted class names) of a tree with
    one subdirectory per class."""
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    paths: List[str] = []
    labels: List[int] = []
    for i, cls in enumerate(classes, start=1):
        cdir = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(i)
    if not paths:
        raise FileNotFoundError(f"no images under {split_dir!r}")
    return paths, np.asarray(labels, np.float32), classes


def _decode(path: str, image_size: int, train: bool,
            mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """File -> (C, H, W) float32 by the reference ImageNet recipe:
    train = short side to 256, random crop, random flip; eval = short
    side to 256, center crop; then channel-normalized."""
    from bigdl_tpu_torch.transform.vision import (AspectScale, CenterCrop,
                                                  ChannelNormalize,
                                                  ImageFeature, MatToTensor,
                                                  RandomCrop, RandomHFlip,
                                                  _resize_bilinear,
                                                  read_image)

    feat = ImageFeature(read_image(path).astype(np.float32))
    chain = [AspectScale(256 if image_size <= 224 else image_size + 32)]
    if train:
        chain += [RandomCrop(image_size, image_size), RandomHFlip()]
    else:
        chain += [CenterCrop(image_size, image_size)]
    chain += [ChannelNormalize(*mean, *std)]
    for t in chain:
        feat = t(feat)
    # an extreme aspect ratio can leave the crop short (AspectScale's
    # max_size cap): force the model's shape so a batch never is ragged
    img = feat.image
    if img.shape[:2] != (image_size, image_size):
        feat[ImageFeature.MAT] = _resize_bilinear(img, image_size,
                                                  image_size)
    feat = MatToTensor()(feat)
    return np.asarray(feat[ImageFeature.SAMPLE], np.float32)


class ImageFolderDataSet(DataSet):
    """File-backed per-process image dataset: each process yields its
    (local batch, labels) slice of every global batch, decoded when the
    batch is asked for."""

    per_process = True

    # reference ImageNet channel statistics (RGB, 0-255 scale)
    IMAGENET_MEAN = (123.68, 116.78, 103.94)
    IMAGENET_STD = (58.395, 57.12, 57.375)

    def __init__(self, root: str, batch_size: int = 32, train: bool = True,
                 image_size: int = 224, split: Optional[str] = None,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD, shuffle: bool = True,
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None):
        split = split or ("train" if train else "val")
        split_dir = os.path.join(root, split)
        if not os.path.isdir(split_dir):
            if train:
                split_dir = root        # flat root/<cls>/*.jpg for training
            else:
                # validating on the training images would be silent
                raise FileNotFoundError(f"no {split!r} split under {root!r}")
        self.paths, self.labels, self.classes = scan_image_folder(split_dir)
        self.batch_size = batch_size
        self.train_mode = train
        self.image_size = image_size
        self.mean, self.std = mean, std
        self.shuffle = shuffle
        self._pid = process_id
        self._nproc = num_processes

    def size(self) -> int:
        return len(self.paths)

    def class_num(self) -> int:
        return len(self.classes)

    def _world(self):
        if self._pid is not None and self._nproc is not None:
            return self._pid, self._nproc
        return process_world()

    def _batch(self, idx, augment: bool):
        feats = np.stack([_decode(self.paths[i], self.image_size, augment,
                                  self.mean, self.std) for i in idx])
        return feats, self.labels[idx]

    def data(self, train: bool = True):
        pid, nproc = self._world()
        n = len(self.paths)
        bs = self.batch_size
        augment = train and self.train_mode
        for mine in iter_process_batches(n, bs, pid, nproc,
                                         shuffle=train and self.shuffle):
            yield self._batch(mine, augment)
        if not train and nproc == 1 and n % bs:
            # eval keeps the ragged tail on one process (several drop it
            # to keep their shard shapes equal)
            yield self._batch(np.arange(n)[(n // bs) * bs:], False)


__all__ = ["scan_image_folder", "ImageFolderDataSet"]
