"""ResNet for CIFAR-10 and ImageNet.

Counterpart of ``bigdl_tpu/models/resnet.py`` (:36-160): basic blocks
for CIFAR (depth 6n+2), bottlenecks for ImageNet (ResNet-50/101/152),
shortcut type B (1x1 conv projection where the shape changes), MSRA
init, and a zero γ on the last BN of each block; and ``main`` (:163),
the CLI: ``python -m bigdl_tpu_torch.models.resnet -f DIR`` trains
ResNet-50 on an image folder under ``DistriOptimizer`` with the
reference recipe (``models/train_util.py``), validating Top1/Top5 and,
with ``--checkpoint``, checkpointing every epoch.  Each block is
``Sequential(ConcatTable(main, shortcut), CAddTable, ReLU)``, as in the
reference.  Parameters are drawn on the host from
``RandomGenerator.RNG`` in the JAX package's order, then the model moves
to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn.layers import (Linear, LogSoftMax, MsraFiller, ReLU,
                                       Reshape, SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, SpatialMaxPooling)
from bigdl_tpu_torch.nn.module import Identity, Sequential
from bigdl_tpu_torch.nn.table_ops import CAddTable, ConcatTable


def _conv(n_in, n_out, k, stride=1, pad=None):
    if pad is None:
        pad = (k - 1) // 2
    return SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                              with_bias=False, init_method=MsraFiller(False))


def _bn(n, zero_init=False):
    bn = SpatialBatchNormalization(n)
    if zero_init:
        with torch.no_grad():
            bn.weight.zero_()
    return bn


def _shortcut(n_in, n_out, stride):
    """Identity where the shapes agree, else a 1x1 strided conv + BN."""
    if n_in == n_out and stride == 1:
        return Identity()
    return Sequential().add(_conv(n_in, n_out, 1, stride, 0)).add(_bn(n_out))


def basic_block(n_in, n_out, stride=1, zero_init_residual=True):
    main = Sequential() \
        .add(_conv(n_in, n_out, 3, stride)).add(_bn(n_out)).add(ReLU()) \
        .add(_conv(n_out, n_out, 3, 1)).add(_bn(n_out, zero_init_residual))
    return Sequential() \
        .add(ConcatTable().add(main).add(_shortcut(n_in, n_out, stride))) \
        .add(CAddTable()).add(ReLU())


def bottleneck(n_in, n_mid, stride=1, zero_init_residual=True, expansion=4):
    n_out = n_mid * expansion
    main = Sequential() \
        .add(_conv(n_in, n_mid, 1, 1, 0)).add(_bn(n_mid)).add(ReLU()) \
        .add(_conv(n_mid, n_mid, 3, stride)).add(_bn(n_mid)).add(ReLU()) \
        .add(_conv(n_mid, n_out, 1, 1, 0)).add(_bn(n_out, zero_init_residual))
    return Sequential() \
        .add(ConcatTable().add(main).add(_shortcut(n_in, n_out, stride))) \
        .add(CAddTable()).add(ReLU())


def build_resnet_cifar(depth: int = 20, class_num: int = 10,
                       device="cuda") -> Sequential:
    """CIFAR-10 ResNet with basic blocks, depth 6n+2 (20/32/44/56/110)."""
    assert (depth - 2) % 6 == 0, "CIFAR depth must be 6n+2"
    dev = resolve_device(device)
    n = (depth - 2) // 6
    model = Sequential()
    model.add(_conv(3, 16, 3, 1)).add(_bn(16)).add(ReLU())
    n_in = 16
    for width, stride in [(16, 1), (32, 2), (64, 2)]:
        for i in range(n):
            model.add(basic_block(n_in, width, stride if i == 0 else 1))
            n_in = width
    model.add(SpatialAveragePooling(8, 8, 1, 1)) \
        .add(Reshape([64])) \
        .add(Linear(64, class_num)) \
        .add(LogSoftMax())
    return model.to(dev)


_IMAGENET_CFG = {
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
    18: (basic_block, [2, 2, 2, 2]),
    34: (basic_block, [3, 4, 6, 3]),
}


def build_resnet_imagenet(depth: int = 50, class_num: int = 1000,
                          device="cuda") -> Sequential:
    """ImageNet ResNet (shortcut B, bottleneck expansion 4)."""
    dev = resolve_device(device)
    block, counts = _IMAGENET_CFG[depth]
    expansion = 4 if block is bottleneck else 1
    model = Sequential()
    model.add(_conv(3, 64, 7, 2, 3)).add(_bn(64)).add(ReLU()) \
        .add(SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    n_in = 64
    for stage, (width, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                             (512, 2)]):
        for i in range(counts[stage]):
            model.add(block(n_in, width, stride if i == 0 else 1))
            n_in = width * expansion
    model.add(SpatialAveragePooling(7, 7, 1, 1, global_pooling=True)) \
        .add(Reshape([n_in])) \
        .add(Linear(n_in, class_num)) \
        .add(LogSoftMax())
    return model.to(dev)


def imagenet_recipe_optim(batch_size: int, n_epochs: int = 90,
                          iterations_per_epoch: int = 5004,
                          base_lr: float = None, warmup_epochs: int = 5):
    """The reference ImageNet recipe: linear-scaled LR with a gradual
    warmup, then multistep decay at epochs 30/60/80, as one
    ``SequentialSchedule`` over iterations."""
    from bigdl_tpu_torch.optim import (SGD, MultiStep, SequentialSchedule,
                                       Warmup)

    if base_lr is None:
        base_lr = 0.1 * batch_size / 256.0
    warm_iters = warmup_epochs * iterations_per_epoch
    sched = SequentialSchedule(iterations_per_epoch)
    if warm_iters > 0:
        sched.add(Warmup((base_lr - 0.1) / max(1, warm_iters)), warm_iters)
    # milestones are absolute epochs; SequentialSchedule offsets its
    # successor's neval by the warmup length, so subtract it here
    sched.add(MultiStep([e * iterations_per_epoch - warm_iters
                         for e in (30, 60, 80)], 0.1),
              n_epochs * iterations_per_epoch)
    return SGD(learningrate=0.1 if warm_iters > 0 else base_lr,
               momentum=0.9, dampening=0.0, nesterov=True,
               weightdecay=1e-4, learningrate_schedule=sched)


def main(argv=None):
    """Console entry (JAX :163).  With ``-f/--data-dir`` (an
    ImageNet-style tree, ``<dir>/train/<class>/*``) this is the
    TrainImageNet path: ResNet (``--depth``, 50 when the depth is not an
    ImageNet one) with the warmup/multistep recipe under
    ``DistriOptimizer``.  Without it the CIFAR ResNet trains on a
    synthetic task.  Returns the optimizer."""
    import argparse
    import logging

    import numpy as np

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--data-dir", default=None,
                    help="ImageNet-style dir (train/<cls>/*); absent = "
                         "synthetic CIFAR task")
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-e", "--max-epoch", type=int, default=1)
    ap.add_argument("--learning-rate", type=float, default=None,
                    help="base LR (ImageNet default: linear-scaled "
                         "0.1*batch/256; CIFAR default: 0.1)")
    ap.add_argument("-n", "--num-samples", type=int, default=1024)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.data_dir:
        from bigdl_tpu_torch.models.train_util import train_imagenet_folder

        depth = args.depth if args.depth in _IMAGENET_CFG else 50
        return train_imagenet_folder(
            lambda class_num, device: build_resnet_imagenet(
                depth=depth, class_num=class_num, device=device),
            lambda bs, ep, it: imagenet_recipe_optim(
                bs, n_epochs=ep, iterations_per_epoch=it,
                base_lr=args.learning_rate),
            args.data_dir, args.batch_size, args.max_epoch,
            image_size=args.image_size, checkpoint=args.checkpoint,
            device=args.device)

    model = build_resnet_cifar(depth=args.depth, device=args.device)
    rs = np.random.RandomState(0)
    x = rs.rand(args.num_samples, 3, 32, 32).astype(np.float32)
    y = (rs.randint(0, 10, args.num_samples) + 1).astype(np.float32)
    opt = Optimizer(model, (x, y), ClassNLLCriterion(),
                    batch_size=args.batch_size,
                    distributed=args.distributed or None, device=args.device)
    opt.set_optim_method(SGD(learningrate=args.learning_rate or 0.1,
                             momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.set_validation(Trigger.every_epoch(), (x, y), [Top1Accuracy()])
    opt.optimize()
    return opt


__all__ = ["basic_block", "bottleneck", "build_resnet_cifar",
           "build_resnet_imagenet", "imagenet_recipe_optim", "main"]


if __name__ == "__main__":
    main()
