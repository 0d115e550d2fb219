"""Inception-v1 (GoogLeNet) and Inception-v2 (BN-Inception).

Counterpart of ``bigdl_tpu/models/inception.py`` (:32-301): the
four-branch ``inception_layer_v1`` (1x1 / 3x3-reduce + 3x3 /
5x5-reduce + 5x5 / pool + projection, joined by a ``Concat`` over the
channels) and the main tower without auxiliary classifiers; the
BatchNorm variant ``inception_layer_v2`` (every conv followed by
``SpatialBatchNormalization``, the 5x5 branch as a double 3x3, the
grid-reduction blocks 3c and 4e at stride 2 beside a max pool); the
reference recipe (SGD with momentum 0.9 and weight decay 1e-4 under a
``Poly(0.5)`` decay); and ``main`` (:194), the CLI:
``python -m bigdl_tpu_torch.models.inception -f DIR`` trains on an
image folder under ``DistriOptimizer`` (``models/train_util.py``),
validating Top1/Top5 and, with ``--checkpoint``, checkpointing every
epoch; without ``-f`` it trains on a synthetic 224x224 task.  Layer
names are the reference's (the Caffe exporter writes them).
Parameters are drawn on the host from ``RandomGenerator.RNG`` in the
JAX package's order, then the model moves to ``device``.
"""

from __future__ import annotations

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn.layers import (Dropout, Linear, LogSoftMax, ReLU,
                                       Reshape, SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution,
                                       SpatialCrossMapLRN, SpatialMaxPooling,
                                       Xavier)
from bigdl_tpu_torch.nn.module import Sequential
from bigdl_tpu_torch.nn.table_ops import Concat


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, name=""):
    return SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                              init_method=Xavier()).set_name(name)


def inception_layer_v1(n_in, config, name_prefix=""):
    """``config = [[1x1], [3x3 reduce, 3x3], [5x5 reduce, 5x5], [pool
    proj]]``."""
    concat = Concat(2)
    concat.add(Sequential().add(
        _conv(n_in, config[0][0], 1, 1, name=name_prefix + "1x1"))
        .add(ReLU()))
    concat.add(Sequential().add(
        _conv(n_in, config[1][0], 1, 1, name=name_prefix + "3x3_reduce"))
        .add(ReLU()).add(
        _conv(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1,
              name=name_prefix + "3x3")).add(ReLU()))
    concat.add(Sequential().add(
        _conv(n_in, config[2][0], 1, 1, name=name_prefix + "5x5_reduce"))
        .add(ReLU()).add(
        _conv(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2,
              name=name_prefix + "5x5")).add(ReLU()))
    concat.add(Sequential().add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
               .add(_conv(n_in, config[3][0], 1, 1,
                          name=name_prefix + "pool_proj")).add(ReLU()))
    return concat


def build_inception_v1(class_num: int = 1000, has_dropout: bool = True,
                       device="cuda") -> Sequential:
    """Inception-v1 without auxiliary classifiers, 224x224 input."""
    dev = resolve_device(device)
    model = Sequential()
    model.add(_conv(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool1/3x3_s2")) \
        .add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("pool1/norm1")) \
        .add(_conv(64, 64, 1, 1, name="conv2/3x3_reduce")) \
        .add(ReLU()) \
        .add(_conv(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")) \
        .add(ReLU()) \
        .add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("conv2/norm2")) \
        .add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool2/3x3_s2")) \
        .add(inception_layer_v1(192, [[64], [96, 128], [16, 32], [32]],
                                "inception_3a/")) \
        .add(inception_layer_v1(256, [[128], [128, 192], [32, 96], [64]],
                                "inception_3b/")) \
        .add(SpatialMaxPooling(3, 3, 2, 2).ceil()) \
        .add(inception_layer_v1(480, [[192], [96, 208], [16, 48], [64]],
                                "inception_4a/")) \
        .add(inception_layer_v1(512, [[160], [112, 224], [24, 64], [64]],
                                "inception_4b/")) \
        .add(inception_layer_v1(512, [[128], [128, 256], [24, 64], [64]],
                                "inception_4c/")) \
        .add(inception_layer_v1(512, [[112], [144, 288], [32, 64], [64]],
                                "inception_4d/")) \
        .add(inception_layer_v1(528, [[256], [160, 320], [32, 128], [128]],
                                "inception_4e/")) \
        .add(SpatialMaxPooling(3, 3, 2, 2).ceil()) \
        .add(inception_layer_v1(832, [[256], [160, 320], [32, 128], [128]],
                                "inception_5a/")) \
        .add(inception_layer_v1(832, [[384], [192, 384], [48, 128], [128]],
                                "inception_5b/")) \
        .add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
    if has_dropout:
        model.add(Dropout(0.4))
    model.add(Reshape([1024])) \
        .add(Linear(1024, class_num,
                    init_method=Xavier()).set_name("loss3/classifier")) \
        .add(LogSoftMax())
    return model.to(dev)


def _conv_bn_relu(seq, n_in, n_out, kw=1, kh=1, sw=1, sh=1, pw=0, ph=0,
                  name=""):
    """conv + ``SpatialBatchNormalization`` + ReLU, v2's building
    block (the conv keeps its bias, as the reference's does)."""
    seq.add(_conv(n_in, n_out, kw, kh, sw, sh, pw, ph, name=name)) \
        .add(SpatialBatchNormalization(n_out).set_name(name + "/bn")) \
        .add(ReLU())
    return seq


def inception_layer_v2(n_in, config, name_prefix=""):
    """``config = ([p1], [r3, c3], [rd3, cd3], (pool kind, proj))``:
    the 1x1 branch (none when p1 is 0: the stride-2 grid-reduction
    form), the 3x3 branch, the double-3x3 branch and an avg or max pool
    branch with a 1x1 projection; in the reduction form the conv towers
    end at stride 2 and the pool branch is a bare stride-2 max pool."""
    reduce_grid = config[0][0] == 0
    stride = 2 if reduce_grid else 1
    concat = Concat(2)
    if not reduce_grid:
        concat.add(_conv_bn_relu(Sequential(), n_in, config[0][0],
                                 name=name_prefix + "1x1"))
    c3 = Sequential()
    _conv_bn_relu(c3, n_in, config[1][0], name=name_prefix + "3x3_reduce")
    _conv_bn_relu(c3, config[1][0], config[1][1], 3, 3, stride, stride, 1,
                  1, name=name_prefix + "3x3")
    concat.add(c3)
    cd = Sequential()
    _conv_bn_relu(cd, n_in, config[2][0],
                  name=name_prefix + "double3x3_reduce")
    _conv_bn_relu(cd, config[2][0], config[2][1], 3, 3, 1, 1, 1, 1,
                  name=name_prefix + "double3x3a")
    _conv_bn_relu(cd, config[2][1], config[2][1], 3, 3, stride, stride, 1,
                  1, name=name_prefix + "double3x3b")
    concat.add(cd)
    pool = Sequential()
    pool_kind, proj = config[3]
    if reduce_grid:
        pool.add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                 .set_name(name_prefix + "pool"))
    else:
        cls = SpatialMaxPooling if pool_kind == "max" \
            else SpatialAveragePooling
        pool.add(cls(3, 3, 1, 1, 1, 1).ceil().set_name(name_prefix + "pool"))
        _conv_bn_relu(pool, n_in, proj, name=name_prefix + "pool_proj")
    concat.add(pool)
    return concat


def build_inception_v2(class_num: int = 1000, device="cuda") -> Sequential:
    """Inception-v2 (BN-Inception), 224x224 input."""
    dev = resolve_device(device)
    model = Sequential()
    _conv_bn_relu(model, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool1/3x3_s2"))
    _conv_bn_relu(model, 64, 64, name="conv2/3x3_reduce")
    _conv_bn_relu(model, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool2/3x3_s2"))
    for n_in, cfg, name in (
            (192, ([64], [64, 64], [64, 96], ("avg", 32)), "3a"),
            (256, ([64], [64, 96], [64, 96], ("avg", 64)), "3b"),
            (320, ([0], [128, 160], [64, 96], ("max", 0)), "3c"),
            (576, ([224], [64, 96], [96, 128], ("avg", 128)), "4a"),
            (576, ([192], [96, 128], [96, 128], ("avg", 128)), "4b"),
            (576, ([160], [128, 160], [128, 160], ("avg", 128)), "4c"),
            (608, ([96], [128, 192], [160, 192], ("avg", 128)), "4d"),
            (608, ([0], [128, 192], [192, 256], ("max", 0)), "4e"),
            (1056, ([352], [192, 320], [160, 224], ("avg", 128)), "5a"),
            (1024, ([352], [192, 320], [192, 224], ("max", 128)), "5b")):
        model.add(inception_layer_v2(n_in, cfg, f"inception_{name}/"))
    model.add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1")) \
        .add(Reshape([1024])) \
        .add(Linear(1024, class_num,
                    init_method=Xavier()).set_name("loss3/classifier")) \
        .add(LogSoftMax())
    return model.to(dev)


def inception_recipe_optim(batch_size: int, n_epochs: int,
                           iterations_per_epoch: int, base_lr: float = None):
    """The reference recipe: SGD with momentum 0.9, dampening 0 and
    weight decay 1e-4, the rate ``0.0898330 · batch / 1024`` decayed by
    ``Poly(0.5)`` over the whole run."""
    from bigdl_tpu_torch.optim import SGD, Poly

    if base_lr is None:
        base_lr = 0.0898330 * batch_size / 1024.0
    max_iter = max(1, n_epochs * iterations_per_epoch)
    return SGD(learningrate=base_lr, momentum=0.9, dampening=0.0,
               weightdecay=1e-4, learningrate_schedule=Poly(0.5, max_iter))


def main(argv=None):
    """Console entry (JAX :194).  With ``-f/--data-dir`` (an
    ImageNet-style tree, ``<dir>/train/<class>/*``) this is the
    TrainImageNet path: Inception v1 or v2 (``--version``) with the
    reference recipe under ``DistriOptimizer``.  Without it the model
    trains on a synthetic 224x224 task of 10 classes.  Returns the
    optimizer."""
    import argparse
    import logging

    import numpy as np

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--data-dir", default=None,
                    help="ImageNet-style dir (train/<cls>/*); absent = "
                         "synthetic 224px task")
    ap.add_argument("--version", choices=["v1", "v2"], default="v1")
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-e", "--max-epoch", type=int, default=1)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("-n", "--num-samples", type=int, default=64)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    build = build_inception_v1 if args.version == "v1" \
        else build_inception_v2

    def make_optim(bs, ep, it):
        return inception_recipe_optim(bs, ep, it, base_lr=args.learning_rate)

    if args.data_dir:
        from bigdl_tpu_torch.models.train_util import train_imagenet_folder

        return train_imagenet_folder(build, make_optim, args.data_dir,
                                     args.batch_size, args.max_epoch,
                                     checkpoint=args.checkpoint, device=dev)

    rs = np.random.RandomState(0)
    n = args.num_samples
    x = rs.rand(n, 3, 224, 224).astype(np.float32)
    y = (rs.randint(0, 10, n) + 1).astype(np.float32)
    model = build(class_num=10, device=dev)
    bs = min(args.batch_size, n)
    opt = Optimizer(model, (x, y), ClassNLLCriterion(), batch_size=bs,
                    device=dev)
    opt.set_optim_method(make_optim(bs, args.max_epoch, max(1, n // bs)))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    opt.optimize()
    return opt


__all__ = ["inception_layer_v1", "build_inception_v1", "inception_layer_v2",
           "build_inception_v2", "inception_recipe_optim", "main"]


if __name__ == "__main__":
    main()
