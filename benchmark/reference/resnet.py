"""Plain ResNet (He et al., arXiv:1512.03385, Table 1) in float32 torch.

Bottleneck blocks with the stride on the 3x3 convolution (ResNet v1.5,
as torchvision and NVIDIA's DeepLearningExamples build it), projection
shortcuts where the shape changes, batch normalization with the
statistics of the batch (training mode), global average pooling, a
linear classifier and the mean cross entropy.  The weights are a dict
(``weight_specs`` names them); nothing here imports the measured program.

``quant="fp8"`` computes every convolution and the classifier as float8
training does: their inputs rounded to e4m3 and the gradients reaching
their outputs to e5m2, each with a scale per tensor; the control
computed in the precision below bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude to 448, with a straight-through gradient."""
    q = _round(x.detach(), torch.float8_e4m3fn, 448.0)
    return x + (q - x).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 (scale per
    tensor), as float8 training carries gradients."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def grad_fp8(y: torch.Tensor) -> torch.Tensor:
    return _GradFp8.apply(y)


def _q(x, quant):
    return fake_fp8(x) if quant == "fp8" else x


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, in channels, mid channels, out channels, stride) of every
    bottleneck, in order."""
    out, n_in = [], cfg["stem_channels"]
    for s, (count, width) in enumerate(zip(cfg["blocks_per_stage"],
                                           cfg["stage_widths"])):
        for b in range(count):
            stride = 2 if (b == 0 and s > 0) else 1
            n_out = width * cfg["expansion"]
            out.append((f"s{s}.b{b}", n_in, width, n_out, stride))
            n_in = n_out
    return out


def convs(cfg: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, in, out, kernel, stride, input size) of every convolution
    that a batch-normalization follows, in the order of the forward, at
    ``image_size``: the stem, then each block's conv1, conv2, conv3 and
    its projection."""
    size = cfg["image_size"]
    out = [("stem", 3, cfg["stem_channels"], 7, 2, size)]
    size = (size + 2 * 3 - 7) // 2 + 1
    size = (size + 2 - 3) // 2 + 1                       # the max pool
    for name, n_in, mid, n_out, stride in blocks(cfg):
        out.append((f"{name}.conv1", n_in, mid, 1, 1, size))
        out.append((f"{name}.conv2", mid, mid, 3, stride, size))
        after = (size - 1) // stride + 1
        out.append((f"{name}.conv3", mid, n_out, 1, 1, after))
        if stride != 1 or n_in != n_out:
            out.append((f"{name}.down", n_in, n_out, 1, stride, size))
        size = after
    return out


def out_size(size: int, k: int, stride: int) -> int:
    return (size + 2 * ((k - 1) // 2) - k) // stride + 1


def weight_specs(cfg: dict) -> List[tuple]:
    """(name, shape, init): convolutions He-normal over their fan-out,
    batch normalization γ 1 and β 0, the classifier N(0, 0.01) and a
    zero bias."""
    specs = []
    for name, c, o, k, _, _ in convs(cfg):
        specs.append((f"{name}.w", (o, c, k, k),
                      ("normal", math.sqrt(2.0 / (o * k * k)))))
        specs.append((f"{name}.bn.w", (o,), ("ones",)))
        specs.append((f"{name}.bn.b", (o,), ("zeros",)))
    feat = cfg["stage_widths"][-1] * cfg["expansion"]
    specs.append(("fc.w", (cfg["num_classes"], feat), ("normal", 0.01)))
    specs.append(("fc.b", (cfg["num_classes"],), ("zeros",)))
    return specs


def _conv_bn(w, name, x, k, stride, relu, quant):
    y = F.conv2d(_q(x, quant), _q(w[f"{name}.w"], quant), stride=stride,
                 padding=(k - 1) // 2)
    if quant == "fp8":
        y = grad_fp8(y)
    y = F.batch_norm(y, None, None, w[f"{name}.bn.w"], w[f"{name}.bn.b"],
                     training=True, eps=BN_EPS)
    return F.relu(y) if relu else y


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            quant=None) -> torch.Tensor:
    """Logits (N, classes) of images x (N, 3, H, W)."""
    h = _conv_bn(w, "stem", x, 7, 2, True, quant)
    h = F.max_pool2d(h, 3, 2, 1)
    for name, n_in, _, n_out, stride in blocks(cfg):
        y = _conv_bn(w, f"{name}.conv1", h, 1, 1, True, quant)
        y = _conv_bn(w, f"{name}.conv2", y, 3, stride, True, quant)
        y = _conv_bn(w, f"{name}.conv3", y, 1, 1, False, quant)
        if stride != 1 or n_in != n_out:
            h = _conv_bn(w, f"{name}.down", h, 1, stride, False, quant)
        h = F.relu(y + h)
    h = h.mean(dim=(2, 3))
    y = F.linear(_q(h, quant), _q(w["fc.w"], quant), w["fc.b"])
    return grad_fp8(y) if quant == "fp8" else y


def loss_sum(w, x, target, cfg, quant=None) -> torch.Tensor:
    """Σ of the cross entropy over the rows; ``target`` 0-based."""
    return F.cross_entropy(forward(w, x, cfg, quant), target,
                           reduction="sum")


def forward_flops_per_sample(cfg: dict) -> float:
    """Forward FLOPs of one image: every convolution and the
    classifier (2 a multiply-add)."""
    total = 0.0
    for _, c, o, k, stride, size in convs(cfg):
        so = out_size(size, k, stride)
        total += 2.0 * c * o * k * k * so * so
    feat = cfg["stage_widths"][-1] * cfg["expansion"]
    return total + 2.0 * feat * cfg["num_classes"]


def model_flops(cfg: dict, mix: dict, record: dict) -> float:
    """A training window's model FLOPs: three times the forward (the
    backward takes twice the forward's products) of every image."""
    return 3.0 * forward_flops_per_sample(cfg) * record["samples"]
