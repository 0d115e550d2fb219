"""Layers of the port: the fillers, ``Linear``, and the ResNet layer set.

Counterpart of ``bigdl_tpu/nn/layers.py``: ``Zeros`` (:49),
``Xavier`` (:93), ``MsraFiller`` (:104), ``Linear`` (:126),
``LookupTable`` (:187), ``SpatialConvolution`` (:261),
``SpatialMaxPooling`` (:606), ``SpatialAveragePooling`` (:654),
``ReLU`` (:739), ``Tanh`` (:757), ``Sigmoid`` (:764), ``LogSoftMax``
(:773), ``BatchNormalization``/``SpatialBatchNormalization`` (:1190,
:1369), ``Reshape`` (:1462) and ``View`` (:1493).  Initial weights are
drawn on the host from the shared numpy ``RandomGenerator.RNG``, in the
same order and shapes as the JAX package, so seeded models start equal.
Layouts are the JAX package's: NCHW activations, OIHW conv weights.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.module import AbstractModule


class InitializationMethod:
    def init(self, shape, fan_in, fan_out):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, shape, fan_in, fan_out):
        return np.zeros(shape, dtype=np.float32)


class Xavier(InitializationMethod):
    """Glorot uniform, the default for ``Linear`` weights."""

    def init(self, shape, fan_in, fan_out):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return RandomGenerator.RNG.uniform(-limit, limit, size=shape).astype(
            np.float32)


class MsraFiller(InitializationMethod):
    """Kaiming/He normal (the ResNet recipe's conv init)."""

    def __init__(self, variance_norm_average=True):
        self.avg = variance_norm_average

    def init(self, shape, fan_in, fan_out):
        n = (fan_in + fan_out) / 2.0 if self.avg else fan_in
        std = math.sqrt(2.0 / max(1.0, n))
        return RandomGenerator.RNG.normal(0.0, std, size=shape).astype(
            np.float32)


class Linear(AbstractModule):
    """``y = x Wᵀ + b`` with the ``(out, in)`` weight of the JAX package."""

    config_names = ("input_size", "output_size", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        init = init_method or Xavier()
        self._set_param("weight", init.init(
            (output_size, input_size), input_size, output_size))
        self._set_param("bias", np.zeros(output_size, np.float32)
                        if with_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"


class LookupTable(AbstractModule):
    """Embedding lookup (JAX :187).  Indices are 1-based (float ids are
    cast to integers first); with ``padding_value`` > 0 that row starts
    at zero; a finite ``max_norm`` rescales each looked-up row to at
    most that ``norm_type`` norm as a function of the weight (the weight
    itself is not rewritten, unlike ``F.embedding(max_norm=...)``)."""

    config_names = ("n_index", "n_output", "padding_value")

    param_names = ("weight",)

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0, max_norm: float = float("inf"),
                 norm_type: float = 2.0):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.reset()

    def reset(self):
        w = RandomGenerator.RNG.normal(
            0.0, 1.0, size=(self.n_index, self.n_output)).astype(np.float32)
        if self.padding_value > 0:
            w[int(self.padding_value) - 1] = 0.0
        self._set_param("weight", w)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = x.long() - 1
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp_max(self.max_norm / (norms + 1e-7), 1.0)
        return F.embedding(idx, w)

    def extra_repr(self):
        return f"{self.n_index}, {self.n_output}"


def _auto_batch(x, full_ndim):
    if x.dim() == full_ndim - 1:
        return x[None], True
    return x, False


class SpatialConvolution(AbstractModule):
    """2-D convolution over NCHW input (JAX :261), width-first argument
    order as in the reference.  Symmetric zero padding; the TF-style
    ``pad == -1`` (SAME) is not ported yet.  Runs ``F.conv2d`` (cuDNN on
    the card): the JAX package leaves this conv to XLA."""

    config_names = ("n_input_plane", "n_output_plane", "kernel_w",
                    "kernel_h", "stride_w", "stride_h", "pad_w", "pad_h",
                    "n_group", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        if pad_w < 0 or pad_h < 0:
            raise ValueError("SpatialConvolution: SAME padding (-1) is not "
                             "ported; give explicit pads")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        init = init_method or MsraFiller(False)
        fan_in = n_input_plane // n_group * kernel_h * kernel_w
        fan_out = n_output_plane // n_group * kernel_h * kernel_w
        self._set_param("weight", init.init(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            fan_in, fan_out))
        self._set_param("bias", np.zeros(n_output_plane, np.float32)
                        if with_bias else None)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        y = F.conv2d(x, self.weight, self.bias,
                     stride=(self.stride_h, self.stride_w),
                     padding=(self.pad_h, self.pad_w), groups=self.n_group)
        return y[0] if squeezed else y

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.stride_w},"
                f"{self.stride_h}, {self.pad_w},{self.pad_h}")


def _pool_pad(in_size, k, s, pad, ceil_mode):
    """Output size and (lo, hi) padding of one spatial dim, as the JAX
    package computes them (layers.py ``_pool_pad``)."""
    if pad == -1:
        out = -(-in_size // s)
        needed = max(0, (out - 1) * s + k - in_size)
        lo = needed // 2
        return out, (lo, needed - lo)
    if ceil_mode:
        out = int(math.ceil((in_size + 2 * pad - k) / s)) + 1
    else:
        out = int(math.floor((in_size + 2 * pad - k) / s)) + 1
    if pad > 0 or ceil_mode:
        # the last window must start inside the padded input
        if (out - 1) * s >= in_size + pad:
            out -= 1
    needed = max(0, (out - 1) * s + k - in_size - pad)
    return out, (pad, needed)


def _pad_for_pool(x, kh, kw, dh, dw, pad_h, pad_w, ceil_mode, value):
    """Pad x explicitly with the JAX window padding, so that a plain
    floor-mode pooling over the result gives the JAX output size."""
    _, ph = _pool_pad(x.shape[2], kh, dh, pad_h, ceil_mode)
    _, pw = _pool_pad(x.shape[3], kw, dw, pad_w, ceil_mode)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SpatialMaxPooling(AbstractModule):
    """Max pooling over NCHW (JAX :606), width-first arguments, padded
    with -inf."""

    config_names = ("kw", "kh", "dw", "dh", "pad_w", "pad_h", "ceil_mode")

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 ceil_mode=False):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        xp = _pad_for_pool(x, self.kh, self.kw, self.dh, self.dw,
                           self.pad_h, self.pad_w, self.ceil_mode,
                           float("-inf"))
        y = F.max_pool2d(xp, (self.kh, self.kw), (self.dh, self.dw))
        return y[0] if squeezed else y


class SpatialAveragePooling(AbstractModule):
    """Average pooling over NCHW (JAX :654); the divisor counts padded
    cells unless ``count_include_pad=False``; ``global_pooling`` pools
    the whole plane."""

    config_names = ("kw", "kh", "dw", "dh", "pad_w", "pad_h",
                    "global_pooling", "ceil_mode", "count_include_pad",
                    "divide")

    def __init__(self, kw, kh, dw=1, dh=1, pad_w=0, pad_h=0,
                 global_pooling=False, ceil_mode=False,
                 count_include_pad=True, divide=True):
        super().__init__()
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        kh, kw = self.kh, self.kw
        if self.global_pooling:
            kh, kw = x.shape[2], x.shape[3]
        args = (kh, kw, self.dh, self.dw, self.pad_h, self.pad_w,
                self.ceil_mode)
        mean = F.avg_pool2d(_pad_for_pool(x, *args, 0.0), (kh, kw),
                            (self.dh, self.dw))
        if not self.divide:
            y = mean * (kh * kw)
        elif self.count_include_pad:
            y = mean
        else:
            ones = torch.ones_like(x[:1, :1])
            frac = F.avg_pool2d(_pad_for_pool(ones, *args, 0.0), (kh, kw),
                                (self.dh, self.dw))
            y = mean / frac
        return y[0] if squeezed else y


class ReLU(AbstractModule):
    """``max(x, 0)`` (JAX :739).  ``torch.maximum`` splits the gradient
    at a tie as ``jnp.maximum`` does (half each way), which matters in
    ResNet: a zero-γ block adds exact zeros to post-ReLU activations,
    so the block's ReLU sees exact zeros."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return torch.maximum(x, x.new_zeros(()))


class Tanh(AbstractModule):
    """JAX :757."""

    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(AbstractModule):
    """JAX :764."""

    def forward(self, x):
        return torch.sigmoid(x)


class LogSoftMax(AbstractModule):
    """Log-softmax over the last (class) dim (JAX :773)."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


def fold_bn(weight, bias, eps, mean, var, center):
    """Fold (mean, var, weight, bias) into per-channel f32 (scale,
    offset) of the centred normalize ``y = (x - center)·scale + offset``
    (JAX ``BatchNormalization._fold``).  ``weight``/``bias`` may be in
    the compute dtype; they are widened to f32 here."""
    inv = torch.rsqrt(var + eps)
    if weight is None:
        return inv, -(mean - center) * inv
    scale = inv * weight.float()
    return scale, bias.float() - (mean - center) * scale


def normalize(x, scale, offset, center, bshape):
    """The centred normalize in x's dtype (JAX layers.py:1296-1306)."""
    dt = x.dtype
    return (x - center.to(dt).reshape(bshape)) * scale.to(dt).reshape(
        bshape) + offset.to(dt).reshape(bshape)


def running_update(momentum, rm, rv, mean, var, n):
    """New (running_mean, running_var) after a training batch of n
    samples per channel: an EMA with the unbiased variance.  Detached:
    the running statistics are state, not part of the gradient."""
    with torch.no_grad():
        unbiased = var * (n / max(1, n - 1))
        return ((1 - momentum) * rm + momentum * mean,
                (1 - momentum) * rv + momentum * unbiased)


class BatchNormalization(AbstractModule):
    """Batch normalization over (N, C) input (JAX :1190).

    The JAX package's contract (layers.py:1345-1362): statistics in f32,
    one pass shifted by the running mean (``mean = rm + d``,
    ``var = max(m2 - d², 0)``, biased), the centred normalize in the
    input dtype, running statistics updated with momentum 0.1 and the
    unbiased variance, and eval mode on the running statistics.  The
    gradient flows through the batch statistics.

    The new running statistics are bound to the buffers as new tensors
    (the old ones are never written in place), so a step's autograd
    graph keeps the values it saw, and a trainer can put the previous
    tensors back (``set_state``) when it skips a step."""

    config_names = ("n_output", "eps", "momentum", "affine")

    param_names = ("weight", "bias")
    state_names = ("running_mean", "running_var")
    _feature_ndim = 2

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight=None, init_bias=None):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self._set_param("weight", init_weight if init_weight is not None
                            else np.ones(n_output, np.float32))
            self._set_param("bias", init_bias if init_bias is not None
                            else np.zeros(n_output, np.float32))
        else:
            self._set_param("weight", None)
            self._set_param("bias", None)
        self.register_buffer("running_mean",
                             torch.zeros(n_output, dtype=torch.float32))
        self.register_buffer("running_var",
                             torch.ones(n_output, dtype=torch.float32))

    def _axes_and_shape(self, x):
        if x.dim() != self._feature_ndim:
            raise ValueError(f"{type(self).__name__} expects "
                             f"{self._feature_ndim}-d input, got {x.dim()}-d")
        if self._feature_ndim == 2:
            return (0,), (1, self.n_output)
        return (0, 2, 3), (1, self.n_output, 1, 1)

    def forward(self, x):
        axes, bshape = self._axes_and_shape(x)
        rm = self.running_mean
        if not self.training:
            scale, offset = fold_bn(self.weight, self.bias, self.eps, rm,
                                    self.running_var, rm)
            return normalize(x, scale, offset, rm, bshape)
        xc = x.float() - rm.reshape(bshape)
        d = xc.mean(dim=axes)
        m2 = (xc * xc).mean(dim=axes)
        mean = rm + d                                   # exact at any shift
        var = torch.clamp_min(m2 - d * d, 0.0)          # biased
        scale, offset = fold_bn(self.weight, self.bias, self.eps, mean, var,
                                rm)
        y = normalize(x, scale, offset, rm, bshape)
        n = 1
        for a in axes:
            n *= x.shape[a]
        self.running_mean, self.running_var = running_update(
            self.momentum, rm, self.running_var, mean, var, n)
        return y

    def extra_repr(self):
        return str(self.n_output)


class SpatialBatchNormalization(BatchNormalization):
    """NCHW batch normalization, statistics per channel (JAX :1369)."""

    _feature_ndim = 4


class Reshape(AbstractModule):
    """Reshape (JAX :1462); ``batch_mode=None`` detects whether the
    first dim is a batch dim as the reference does."""

    config_names = ("size", "batch_mode")

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode
        self._nelement = int(np.prod(self.size))

    def forward(self, x):
        total = x.numel()
        batched = self.batch_mode
        if batched is None:
            batched = total != self._nelement or (
                x.shape[0] == 1 and x.dim() > len(self.size)
                and int(np.prod(x.shape[1:])) == self._nelement)
        if batched:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class View(AbstractModule):
    """Reshape with a -1 wildcard (JAX :1493); without one, the batch
    dim is kept when the sizes do not consume every element."""

    config_names = ("sizes",)

    def __init__(self, *sizes, **kwargs):
        super().__init__()
        if not sizes and "sizes" in kwargs:
            sizes = tuple(kwargs["sizes"])
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)

    def forward(self, x):
        total = x.numel()
        known = int(np.prod([s for s in self.sizes if s != -1]))
        if -1 in self.sizes:
            return x.reshape(tuple(total // known if s == -1 else s
                                   for s in self.sizes))
        if known == total:
            return x.reshape(self.sizes)
        return x.reshape((x.shape[0],) + self.sizes)


__all__ = ["InitializationMethod", "Zeros", "Xavier", "MsraFiller", "Linear",
           "LookupTable", "SpatialConvolution", "SpatialMaxPooling",
           "SpatialAveragePooling",
           "ReLU", "Tanh", "Sigmoid", "LogSoftMax", "BatchNormalization",
           "SpatialBatchNormalization", "Reshape", "View", "fold_bn",
           "normalize", "running_update"]
