"""The ImageNet-folder training flow shared by the model CLIs.

Counterpart of ``bigdl_tpu/models/train_util.py``:
``train_imagenet_folder`` (:12) trains a model family on
``<dir>/train/<class>/*`` under ``DistriOptimizer`` with its recipe,
validates Top1/Top5 on ``<dir>/val`` every epoch when that split
exists, and with ``checkpoint`` writes a checkpoint every epoch.
"""

from __future__ import annotations


def train_imagenet_folder(build_model, make_optim, data_dir: str,
                          batch_size: int, max_epoch: int,
                          image_size: int = 224, checkpoint: str = None,
                          device="cuda"):
    """Train ``build_model(class_num=..., device=...)`` on an image
    folder; ``make_optim(batch_size, n_epochs, iterations_per_epoch)``
    gives the family's ``OptimMethod``.  Returns the optimizer (its
    ``model``, ``state`` and validation scores)."""
    from bigdl_tpu_torch.dataset.imagenet import ImageFolderDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer

    if not Engine.is_initialized():
        Engine.init(device)
    dev = Engine.device()
    train_ds = ImageFolderDataSet(data_dir, batch_size=batch_size,
                                  train=True, image_size=image_size)
    model = build_model(class_num=train_ds.class_num(), device=dev)
    iters = max(1, train_ds.size() // batch_size)
    opt = DistriOptimizer(model, train_ds, ClassNLLCriterion(),
                          batch_size=batch_size, device=dev)
    opt.set_optim_method(make_optim(batch_size, max_epoch, iters))
    opt.set_end_when(Trigger.max_epoch(max_epoch))
    try:
        val_ds = ImageFolderDataSet(data_dir, batch_size=batch_size,
                                    train=False, image_size=image_size)
        opt.set_validation(Trigger.every_epoch(), val_ds,
                           [Top1Accuracy(), Top5Accuracy()])
    except FileNotFoundError:
        pass    # no val split
    if checkpoint:
        opt.set_checkpoint(checkpoint, Trigger.every_epoch())
    opt.optimize()
    return opt


__all__ = ["train_imagenet_folder"]
