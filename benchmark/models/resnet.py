"""The program's ResNet as a cell runs it: ``models/resnet.py``'s
ImageNet builder, its 1x1 and 3x3 conv + BN pairs fused onto the
``conv_bn`` kernels (``nn/fused.py``), under the configuration's
criterion: ``ClassNLLCriterion`` after the builder's ``LogSoftMax``, as
the program's ImageNet entry trains it, or ``CrossEntropyCriterion`` on
the logits (the ``LogSoftMax`` dropped)."""

from __future__ import annotations

import torch

from benchmark.models import kernels


def build(cfg: dict, device):
    kernels(device)
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn.fused import fuse_conv_bn

    model = build_resnet_imagenet(depth=cfg["depth"],
                                  class_num=cfg["num_classes"], device=device)
    if cfg["criterion"] == "CrossEntropyCriterion":
        # the criterion takes the logits: the builder's LogSoftMax goes
        model.modules = model.modules[:-1]
    if cfg.get("fuse_kernels"):
        fuse_conv_bn(model, kernels=tuple(cfg["fuse_kernels"]))
    return model


def criterion(cfg: dict):
    from bigdl_tpu_torch import nn

    return getattr(nn, cfg["criterion"])()


def _owned(model):
    """The program's parameters in the reference's order: each conv's
    weight with its BN's γ and β (fused or not), then the classifier."""
    from bigdl_tpu_torch.nn.fused import SpatialConvolutionBatchNorm
    from bigdl_tpu_torch.nn.layers import (Linear, SpatialBatchNormalization,
                                           SpatialConvolution)

    out = []
    for m in torch.nn.Module.modules(model):
        if isinstance(m, SpatialConvolutionBatchNorm):
            out += [m.weight, m.bn_weight, m.bn_bias]
        elif isinstance(m, SpatialConvolution):
            out.append(m.weight)
        elif isinstance(m, SpatialBatchNormalization):
            out += [m.weight, m.bias]
        elif isinstance(m, Linear):
            out += [m.weight, m.bias]
    return out


def load(model, w: dict, ref, cfg: dict) -> dict:
    """Copy the benchmark's weights into the program's parameters;
    returns {id(parameter): reference name}."""
    names = [n for n, _, _ in ref.weight_specs(cfg)]
    params = _owned(model)
    if len(params) != len(names):
        raise ValueError(f"{len(params)} program parameters against "
                         f"{len(names)} of the reference")
    with torch.no_grad():
        for p, n in zip(params, names):
            if p.numel() != w[n].numel():
                raise ValueError(f"{n}: {tuple(p.shape)} against "
                                 f"{tuple(w[n].shape)}")
            p.copy_(w[n].reshape(p.shape))
    return {id(p): n for p, n in zip(params, names)}
