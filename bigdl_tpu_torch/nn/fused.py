"""Fused conv + BatchNorm (+ReLU) module and the model transform.

Counterpart of ``bigdl_tpu/nn/fused.py``.  ``SpatialConvolutionBatchNorm``
computes a bias-free 1x1 or kxk convolution with the BN statistics
taken in the conv's epilogue (``ops/conv_bn.py``, the ``conv_bn_1x1``
and ``conv_bn_kxk`` kernels on the card), so training-mode BN never
reads the activation again.  It means exactly ``SpatialConvolution(
with_bias=False) -> SpatialBatchNormalization (-> ReLU)``: the same
shifted single-pass statistics and running-stat updates as
``nn/layers.py``.

``fuse_conv_bn(model)`` rewrites those runs inside ``Sequential``
containers in place and returns the model.  The fused module shares the
pair's BN parameters and buffers, and its weight is a view of the
conv's (reshaped to (O, C) for 1x1), so a fused model trains the same
tensors the unfused one held at fuse time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import (MsraFiller, ReLU,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, fold_bn,
                                       normalize, running_update)
from bigdl_tpu_torch.nn.module import AbstractModule, Container, Sequential
from bigdl_tpu_torch.ops.conv_bn import conv_bn_stats

_BSHAPE = (1, -1, 1, 1)


class SpatialConvolutionBatchNorm(AbstractModule):
    """Fused ``conv (no bias) + SpatialBatchNormalization`` with an
    optional fused ReLU (JAX ``fused.py:38``).  Kernel k with
    torch-style symmetric padding ``(k-1)//2``.  Weight layout
    (n_output, n_input) for 1x1, as the JAX package keeps it, and
    (n_output, n_input, k, k) otherwise."""

    param_names = ("weight", "bn_weight", "bn_bias")
    state_names = ("running_mean", "running_var")
    config_names = ("n_input_plane", "n_output_plane", "stride", "eps",
                    "momentum", "with_relu", "kernel")

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 stride: int = 1, eps: float = 1e-5, momentum: float = 0.1,
                 with_relu: bool = False, kernel: int = 1):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.stride = stride
        self.eps = eps
        self.momentum = momentum
        self.with_relu = with_relu
        self.kernel = kernel
        self.pad = (kernel - 1) // 2
        shape = (n_output_plane, n_input_plane) if kernel == 1 \
            else (n_output_plane, n_input_plane, kernel, kernel)
        # drawn as the JAX module draws it, so that fusing consumes the
        # same RNG numbers in both packages
        self._set_param("weight", MsraFiller(False).init(
            shape, n_input_plane * kernel * kernel, n_output_plane))
        self._set_param("bn_weight", torch.ones(n_output_plane))
        self._set_param("bn_bias", torch.zeros(n_output_plane))
        self.register_buffer("running_mean", torch.zeros(n_output_plane))
        self.register_buffer("running_var", torch.ones(n_output_plane))

    @classmethod
    def from_pair(cls, conv: SpatialConvolution,
                  bn: SpatialBatchNormalization, with_relu: bool):
        k = conv.kernel_w
        assert conv.kernel_h == k and k % 2 == 1
        assert conv.stride_w == conv.stride_h
        assert conv.pad_w == conv.pad_h == (k - 1) // 2
        assert not conv.with_bias and conv.n_group == 1
        m = cls(conv.n_input_plane, conv.n_output_plane,
                stride=conv.stride_w, eps=bn.eps, momentum=bn.momentum,
                with_relu=with_relu, kernel=k).to(conv.weight.device)
        w = conv.weight
        m.weight = w if k != 1 else torch.nn.Parameter(
            w.detach()[:, :, 0, 0], requires_grad=w.requires_grad)
        if bn.affine:
            m.bn_weight = bn.weight
            m.bn_bias = bn.bias
        m.running_mean = bn.running_mean
        m.running_var = bn.running_var
        return m

    def forward(self, x):
        w = self.weight.to(x.dtype)
        rm = self.running_mean
        if not self.training:
            if self.kernel == 1:
                if self.stride != 1:
                    x = x[:, :, ::self.stride, ::self.stride]
                y = F.conv2d(x, w[:, :, None, None])
            else:
                y = F.conv2d(x, w, stride=self.stride, padding=self.pad)
            scale, offset = fold_bn(self.bn_weight, self.bn_bias, self.eps,
                                    rm, self.running_var, rm)
            return self._finish(y, scale, offset, rm)
        y, s1, s2 = conv_bn_stats(x, w, rm, stride=self.stride, pad=self.pad)
        n = y.shape[0] * y.shape[2] * y.shape[3]
        d = s1 / n
        m2 = s2 / n
        mean = rm + d                                   # exact at any shift
        var = torch.clamp_min(m2 - d * d, 0.0)
        scale, offset = fold_bn(self.bn_weight, self.bn_bias, self.eps, mean,
                                var, rm)
        out = self._finish(y, scale, offset, rm)
        self.running_mean, self.running_var = running_update(
            self.momentum, rm, self.running_var, mean, var, n)
        return out

    def _finish(self, y, scale, offset, center):
        out = normalize(y, scale, offset, center, _BSHAPE)
        return torch.maximum(out, out.new_zeros(())) if self.with_relu \
            else out

    def extra_repr(self):
        tail = " + ReLU" if self.with_relu else ""
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel}x{self.kernel}/{self.stride}{tail}")


def _is_fusable_conv(m, kernels=(1, 3)):
    """A square, torch-padded, bias-free, ungrouped conv of a size in
    ``kernels`` at stride 1 or 2 (JAX ``fused.py:170-183``).  The 7x7
    stem stays a plain conv."""
    return (type(m) is SpatialConvolution
            and m.kernel_w == m.kernel_h
            and m.kernel_w in kernels
            and m.stride_w == m.stride_h
            and m.stride_w in (1, 2)
            and m.pad_w == m.pad_h == (m.kernel_w - 1) // 2
            and m.n_group == 1 and not m.with_bias)


def fuse_conv_bn(model, kernels=(1, 3)):
    """Rewrite every ``[conv (no bias), SpatialBatchNormalization,
    (ReLU)]`` run inside ``Sequential`` containers into one
    ``SpatialConvolutionBatchNorm``, recursively.  In place; returns
    the model.  ``kernels`` restricts which conv sizes fuse."""
    if isinstance(model, Container):
        for child in model.modules:
            fuse_conv_bn(child, kernels)
    if isinstance(model, Sequential):
        mods = list(model.modules)
        out = []
        i = 0
        while i < len(mods):
            m = mods[i]
            nxt = mods[i + 1] if i + 1 < len(mods) else None
            if (_is_fusable_conv(m, kernels)
                    and type(nxt) is SpatialBatchNormalization
                    and nxt.affine and nxt.n_output == m.n_output_plane):
                with_relu = i + 2 < len(mods) and type(mods[i + 2]) is ReLU
                out.append(SpatialConvolutionBatchNorm.from_pair(
                    m, nxt, with_relu))
                i += 3 if with_relu else 2
            else:
                out.append(m)
                i += 1
        model.modules = out
    return model


__all__ = ["SpatialConvolutionBatchNorm", "fuse_conv_bn"]
