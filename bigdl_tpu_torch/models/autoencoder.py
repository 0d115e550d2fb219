"""The MNIST autoencoder.

Counterpart of ``bigdl_tpu/models/autoencoder.py`` (:12-37): a
784 → 32 → 784 MLP (ReLU, then Sigmoid) trained by ``Adagrad`` on
``MSECriterion`` against its own input scaled to [0, 1].
"""

from __future__ import annotations

from bigdl_tpu_torch.common import resolve_device
from bigdl_tpu_torch.nn import Linear, ReLU, Reshape, Sequential, Sigmoid


def build_autoencoder(class_num: int = 32, device="cuda") -> Sequential:
    dev = resolve_device(device)
    model = Sequential()
    model.add(Reshape([28 * 28])) \
        .add(Linear(28 * 28, class_num)) \
        .add(ReLU()) \
        .add(Linear(class_num, 28 * 28)) \
        .add(Sigmoid())
    return model.to(dev)


def train_autoencoder(data_dir=None, batch_size=128, max_epoch=3,
                      learning_rate=0.01, device="cuda"):
    """Train on MNIST (or the synthetic task) with target = input / 255;
    returns (model, optimizer)."""
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import Adagrad, LocalOptimizer, Trigger

    dev = resolve_device(device)
    x, _ = load_mnist(data_dir, "train")
    x = (x / 255.0).astype("float32")
    flat_target = x.reshape(x.shape[0], -1)
    model = build_autoencoder(device=dev)
    opt = LocalOptimizer(model, (x, flat_target), MSECriterion(),
                         batch_size, device=dev)
    opt.set_optim_method(Adagrad(learningrate=learning_rate))
    opt.set_end_when(Trigger.max_epoch(max_epoch))
    return opt.optimize(), opt


__all__ = ["build_autoencoder", "train_autoencoder"]
