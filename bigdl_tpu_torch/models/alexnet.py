"""AlexNet (counterpart of ``bigdl_tpu/models/alexnet.py``): the
single-tower OWT variant at 227 px and the grouped original with
cross-map LRN, layer for layer and name for name as JAX builds them."""

from __future__ import annotations

from bigdl_tpu_torch.nn import (Dropout, Linear, LogSoftMax, ReLU, Reshape,
                                Sequential, SpatialConvolution,
                                SpatialCrossMapLRN, SpatialMaxPooling)


def build_alexnet(class_num: int = 1000, has_dropout: bool = True):
    """AlexNet_OWT (JAX :22): 227 x 227 input."""
    model = Sequential()
    model.add(SpatialConvolution(3, 64, 11, 11, 4, 4).set_name("conv1")) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool1")) \
        .add(SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2).set_name("conv2")) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool2")) \
        .add(SpatialConvolution(192, 384, 3, 3, 1, 1, 1, 1).set_name("conv3")) \
        .add(ReLU()) \
        .add(SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1).set_name("conv4")) \
        .add(ReLU()) \
        .add(SpatialConvolution(256, 256, 3, 3, 1, 1, 1, 1).set_name("conv5")) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool5")) \
        .add(Reshape([256 * 6 * 6]))
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(256 * 6 * 6, 4096).set_name("fc6")).add(ReLU())
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, 4096).set_name("fc7")).add(ReLU())
    model.add(Linear(4096, class_num).set_name("fc8")).add(LogSoftMax())
    return model


def build_alexnet_original(class_num: int = 1000):
    """The grouped original (JAX :49): 224 x 224 input, ``n_group=2``
    convs, cross-map LRN."""
    model = Sequential()
    model.add(SpatialConvolution(3, 96, 11, 11, 4, 4).set_name("conv1")) \
        .add(ReLU()) \
        .add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1")) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool1")) \
        .add(SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2)
             .set_name("conv2")) \
        .add(ReLU()) \
        .add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2")) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool2")) \
        .add(SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1).set_name("conv3")) \
        .add(ReLU()) \
        .add(SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, n_group=2)
             .set_name("conv4")) \
        .add(ReLU()) \
        .add(SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, n_group=2)
             .set_name("conv5")) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool5")) \
        .add(Reshape([256 * 6 * 6])) \
        .add(Linear(256 * 6 * 6, 4096).set_name("fc6")).add(ReLU()) \
        .add(Dropout(0.5)) \
        .add(Linear(4096, 4096).set_name("fc7")).add(ReLU()) \
        .add(Dropout(0.5)) \
        .add(Linear(4096, class_num).set_name("fc8")) \
        .add(LogSoftMax())
    return model


__all__ = ["build_alexnet", "build_alexnet_original"]
