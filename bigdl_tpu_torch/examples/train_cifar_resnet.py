"""ResNet on CIFAR-10, the runnable image-classification example.

Counterpart of ``examples/imageclassification/train_cifar_resnet.py``:
``build_resnet_cifar`` (depth ``6n + 2``) trained by the ``Optimizer``
factory with SGD (momentum 0.9, Nesterov, weight decay 1e-4, the
``Poly(2)`` schedule) and ``CrossEntropyCriterion``, validated by Top-1
every epoch.  With no dataset on disk it trains on the same
deterministic synthetic CIFAR-shaped task as the JAX example (colored
blobs whose place and channel follow the class), so it always runs end
to end.  The flags are the JAX example's, with ``--device`` added
(default the card):

    python -m bigdl_tpu_torch.examples.train_cifar_resnet --depth 20 \\
        --batch-size 128 --max-epoch 2
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def synthetic_cifar(n_train=2048, n_val=512, seed=0):
    """Class-dependent colored blobs: learnable and deterministic (the
    JAX example's task, number for number)."""
    rs = np.random.RandomState(seed)
    n = n_train + n_val
    y = rs.randint(0, 10, n)
    x = rs.randn(n, 3, 32, 32).astype(np.float32) * 0.3
    for i in range(n):
        c = y[i]
        x[i, c % 3, (c * 3) % 28:(c * 3) % 28 + 4, :] += 1.5
        x[i, (c + 1) % 3, :, (c * 2) % 28:(c * 2) % 28 + 4] -= 1.2
    labels = (y + 1).astype(np.float32)  # 1-based (ClassNLL convention)
    return (x[:n_train], labels[:n_train]), (x[n_train:], labels[n_train:])


def main(argv=None):
    """Train as the JAX example does; returns the last validation's
    Top-1 accuracy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-e", "--max-epoch", type=int, default=2)
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from bigdl_tpu_torch.models import build_resnet_cifar
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer, SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.optim_method import Poly

    (x, y), (vx, vy) = synthetic_cifar()
    model = build_resnet_cifar(depth=args.depth, class_num=10,
                               device=args.device)
    n_iters = args.max_epoch * (len(x) // args.batch_size)
    if args.distributed:
        from bigdl_tpu_torch.engine import Engine

        Engine.init(args.device)
    optimizer = Optimizer(
        model=model,
        training_set=(x, y),
        criterion=CrossEntropyCriterion(),
        batch_size=args.batch_size,
        distributed=args.distributed,
        device=args.device,
    )
    optimizer.set_optim_method(
        SGD(learningrate=args.learning_rate, momentum=0.9,
            dampening=0.0, nesterov=True, weightdecay=1e-4,
            learningrate_schedule=Poly(2.0, n_iters))
    ).set_end_when(Trigger.max_epoch(args.max_epoch)) \
        .set_validation(trigger=Trigger.every_epoch(), dataset=(vx, vy),
                        methods=[Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint)
    optimizer.optimize()
    return optimizer.state["score"]


if __name__ == "__main__":
    main()
