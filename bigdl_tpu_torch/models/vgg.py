"""VGG-16/19 (ImageNet) and the CIFAR VGG.

Counterpart of ``bigdl_tpu/models/vgg.py`` (:26-80): the Caffe-layout
conv stacks of VGG-16 and VGG-19 (3x3 convs, 2x2 max pools, three
fully connected layers with dropout) and the conv + BN CIFAR variant.
Parameters are drawn on the host from ``RandomGenerator.RNG`` in the
JAX package's order, then the model moves to ``device``.
"""

from __future__ import annotations

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn.layers import (BatchNormalization, Dropout, Linear,
                                       LogSoftMax, ReLU, Reshape,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, SpatialMaxPooling)
from bigdl_tpu_torch.nn.module import Sequential

_VGG16 = [2, 2, 3, 3, 3]
_VGG19 = [2, 2, 4, 4, 4]
_WIDTHS = [64, 128, 256, 512, 512]


def _build_vgg_imagenet(counts, class_num, device):
    dev = resolve_device(device)
    model = Sequential()
    n_in = 3
    for width, n in zip(_WIDTHS, counts):
        for _ in range(n):
            model.add(SpatialConvolution(n_in, width, 3, 3, 1, 1, 1, 1))
            model.add(ReLU())
            n_in = width
        model.add(SpatialMaxPooling(2, 2, 2, 2))
    model.add(Reshape([512 * 7 * 7])) \
        .add(Linear(512 * 7 * 7, 4096)).add(ReLU()).add(Dropout(0.5)) \
        .add(Linear(4096, 4096)).add(ReLU()).add(Dropout(0.5)) \
        .add(Linear(4096, class_num)) \
        .add(LogSoftMax())
    return model.to(dev)


def build_vgg16(class_num: int = 1000, device="cuda") -> Sequential:
    """VGG-16 at 224x224 (13 convs, 3 fully connected layers)."""
    return _build_vgg_imagenet(_VGG16, class_num, device)


def build_vgg19(class_num: int = 1000, device="cuda") -> Sequential:
    """VGG-19 at 224x224 (16 convs, 3 fully connected layers)."""
    return _build_vgg_imagenet(_VGG19, class_num, device)


def build_vgg_cifar(class_num: int = 10, device="cuda") -> Sequential:
    """The CIFAR VGG: conv + BN blocks at 32x32, two 512-wide heads
    with BatchNormalization and Dropout."""
    dev = resolve_device(device)
    model = Sequential()
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    for item in cfg:
        if item == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2))
        else:
            n_in, n_out = item
            model.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1))
            model.add(SpatialBatchNormalization(n_out))
            model.add(ReLU())
    model.add(Reshape([512])) \
        .add(Linear(512, 512)).add(BatchNormalization(512)).add(ReLU()) \
        .add(Dropout(0.5)) \
        .add(Linear(512, class_num)) \
        .add(LogSoftMax())
    return model.to(dev)


__all__ = ["build_vgg16", "build_vgg19", "build_vgg_cifar"]
