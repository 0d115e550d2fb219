"""LeNet-5 on MNIST, trained with validation.

Counterpart of ``bigdl_tpu/models/lenet.py``: ``build_lenet5`` (:22),
``train_lenet`` (:39) and ``main`` (:79): Reshape, conv 5x5x6, tanh,
max pool, conv 5x5x12, tanh, max pool, Linear(100), tanh, Linear(10),
LogSoftMax, trained by ``SGD`` on ``ClassNLLCriterion`` through the
``Optimizer`` factory and validated by ``Top1Accuracy`` every epoch,
under ``DistriOptimizer`` with ``distributed=True`` and checkpointed
every epoch with ``checkpoint_path``.  Run on the card with ``python -m
bigdl_tpu_torch.models.lenet``; with no MNIST idx files it trains on
the synthetic task.
"""

from __future__ import annotations

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn import (Linear, LogSoftMax, Reshape, Sequential,
                                SpatialConvolution, SpatialMaxPooling, Tanh)


def build_lenet5(class_num: int = 10, device="cuda") -> Sequential:
    """LeNet-5 over (N, 28, 28) images, drawn from
    ``RandomGenerator.RNG`` in JAX's order, then moved to ``device``."""
    dev = resolve_device(device)
    model = Sequential()
    model.add(Reshape([1, 28, 28])) \
        .add(SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5")) \
        .add(Tanh()) \
        .add(SpatialMaxPooling(2, 2, 2, 2)) \
        .add(SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5")) \
        .add(Tanh()) \
        .add(SpatialMaxPooling(2, 2, 2, 2)) \
        .add(Reshape([12 * 4 * 4])) \
        .add(Linear(12 * 4 * 4, 100).set_name("fc1")) \
        .add(Tanh()) \
        .add(Linear(100, class_num).set_name("score")) \
        .add(LogSoftMax())
    return model.to(dev)


def train_lenet(data_dir: str = None, batch_size: int = 128,
                max_epoch: int = 2, learning_rate: float = 0.05,
                checkpoint_path: str = None, distributed: bool = False,
                device="cuda"):
    """Train on MNIST (or the synthetic task), validating Top1 after
    every epoch; returns (model, optimizer).  ``distributed`` trains
    under ``DistriOptimizer``; ``checkpoint_path`` writes a checkpoint
    there every epoch."""
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

    dev = resolve_device(device)
    x_train, y_train = load_mnist(data_dir, "train")
    x_test, y_test = load_mnist(data_dir, "test")
    train_ds = ArrayDataSet(normalize(x_train), y_train, batch_size)
    test_ds = ArrayDataSet(normalize(x_test), y_test, batch_size)
    optimizer = Optimizer(model=build_lenet5(device=dev),
                          training_set=train_ds,
                          criterion=ClassNLLCriterion(),
                          batch_size=batch_size, distributed=distributed,
                          device=dev)
    optimizer.set_optim_method(SGD(learningrate=learning_rate)) \
        .set_end_when(Trigger.max_epoch(max_epoch)) \
        .set_validation(trigger=Trigger.every_epoch(), dataset=test_ds,
                        methods=[Top1Accuracy()])
    if checkpoint_path:
        optimizer.set_checkpoint(checkpoint_path, Trigger.every_epoch())
    return optimizer.optimize(), optimizer


def main(argv=None):
    """Console entry: train LeNet-5 and log each epoch's Top1."""
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--data-dir", default=None)
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-e", "--max-epoch", type=int, default=2)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train_lenet(args.data_dir, args.batch_size, args.max_epoch,
                args.learning_rate, args.checkpoint, args.distributed,
                args.device)


if __name__ == "__main__":
    main()
