"""Transfer learning: a frozen backbone and a trainable head.

Counterpart of ``examples/imageclassification/finetune_frozen_backbone.py``:
a small conv backbone is "pretrained" end to end on one synthetic task,
frozen with ``model.freeze("backbone")``, and a fresh head is trained on
a second task (the same patches, permuted labels).  The backbone must
come out bit-identical while the head learns; the script returns the
fine-tuned Top-1 accuracy on the second task.  The flags are the JAX
example's, with ``--device`` added (default the card):

    python -m bigdl_tpu_torch.examples.finetune_frozen_backbone
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger("finetune")


def synthetic_images(n, n_class, seed):
    """Class-dependent patches on noise (the JAX example's task)."""
    rs = np.random.RandomState(seed)
    y = (rs.randint(0, n_class, n) + 1).astype(np.float32)
    x = rs.rand(n, 3, 16, 16).astype(np.float32) * 0.2
    for i in range(n):
        c = int(y[i]) - 1
        x[i, c % 3, 2 + c:10 + c, 2:10] += 0.8  # class-dependent patch
    return x, y


def build(n_class):
    """(model, backbone, head), the backbone and head named as the
    freeze call and the JAX example name them."""
    from bigdl_tpu_torch.nn import (Linear, LogSoftMax, ReLU, Reshape,
                                    Sequential, SpatialConvolution,
                                    SpatialMaxPooling)

    backbone = Sequential() \
        .add(SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1)) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(2, 2)) \
        .add(SpatialConvolution(8, 16, 3, 3, 1, 1, 1, 1)) \
        .add(ReLU()) \
        .add(SpatialMaxPooling(2, 2)) \
        .add(Reshape([16 * 4 * 4], batch_mode=True))
    backbone.set_name("backbone")
    head = Sequential() \
        .add(Linear(256, n_class)).add(LogSoftMax())
    head.set_name("head")
    return Sequential().add(backbone).add(head), backbone, head


def _weights(module):
    """Host copies of a module's parameters, in JAX's leaf order."""
    from bigdl_tpu_torch.utils import tree as T

    return [v.detach().cpu().numpy().copy()
            for v in T.leaves(module.params())]


def main(argv=None):
    """Pretrain, freeze, fine-tune; returns the head's Top-1 accuracy
    (raises if a backbone weight moved)."""
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("-e", "--max-epoch", type=int, default=6)
    p.add_argument("--learning-rate", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                    Sequential)
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.optim.evaluator import evaluate_dataset
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer

    n_class = 3
    model, backbone, head = build(n_class)

    # phase 1: "pretrain" end to end
    x1, y1 = synthetic_images(512, n_class, seed=0)
    opt = LocalOptimizer(model, (x1, y1), ClassNLLCriterion(),
                         batch_size=args.batch_size, device=args.device)
    opt.set_optim_method(SGD(learningrate=args.learning_rate))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.optimize()

    # phase 2: freeze the backbone, swap in a fresh head, fine-tune on a
    # new task (same patches, permuted labels)
    model.freeze("backbone")
    w_frozen = _weights(backbone)
    model.modules[1] = Sequential() \
        .add(Linear(256, n_class)).add(LogSoftMax())
    x2, y2 = synthetic_images(512, n_class, seed=1)
    y2 = ((y2 % n_class) + 1).astype(np.float32)  # permuted labels
    opt2 = LocalOptimizer(model, (x2, y2), ClassNLLCriterion(),
                          batch_size=args.batch_size, device=args.device)
    opt2.set_optim_method(SGD(learningrate=args.learning_rate))
    opt2.set_end_when(Trigger.max_epoch(args.max_epoch))
    trained = opt2.optimize()

    for before, after in zip(w_frozen, _weights(backbone)):
        np.testing.assert_array_equal(before, after)
    log.info("backbone bit-identical after fine-tune (frozen)")

    (acc,) = evaluate_dataset(trained, ArrayDataSet(x2, y2,
                                                    args.batch_size),
                              [Top1Accuracy()], device=args.device)
    value, _ = acc.result()
    log.info("fine-tuned head Top1Accuracy: %.4f", value)
    return value


if __name__ == "__main__":
    main()
