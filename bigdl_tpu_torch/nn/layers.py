"""Layers of the port: every layer class of the JAX package's layers.

Counterpart of ``bigdl_tpu/nn/layers.py``: ``Zeros`` (:49),
``Xavier`` (:93), ``MsraFiller`` (:104), ``Linear`` (:126),
``LookupTable`` (:187), ``SpatialConvolution`` (:261),
``SpatialMaxPooling`` (:606), ``SpatialAveragePooling`` (:654),
``ReLU`` (:739), ``Tanh`` (:757), ``Sigmoid`` (:764), ``LogSoftMax``
(:773), ``BatchNormalization``/``SpatialBatchNormalization`` (:1190,
:1369), ``Reshape`` (:1462) and ``View`` (:1493); and the layers of
Inception, VGG and the Caffe loader: ``SpatialDilatedConvolution``
(:368), ``SpatialFullConvolution`` (:416), ``SoftMax`` (:782),
``SoftPlus`` (:800), ``ELU`` (:821), ``LeakyReLU`` (:834), ``PReLU``
(:884), ``Abs`` (:932), ``Power`` (:953), ``Log`` (:964), ``Exp``
(:971), ``Scale`` (:1169), ``SpatialCrossMapLRN`` (:1394) and
``Dropout`` (:1425); and the rest, each cited by line in its
docstring: the init methods (:54-83), ``TemporalConvolution`` (:518),
SAME padding (:253), the elementwise layers (:750-1108), the learnable
and similarity ones, the shape ops, resampling and ``Normalize``
(:1110-1765), the gradient-shaping layers (:1773-1846) and ``Cosine``,
``Euclidean``, ``Bilinear`` (:1854-1930).  Initial weights are drawn on
the host from the shared numpy ``RandomGenerator.RNG``, in the same
order and shapes as the JAX package, so seeded models start equal.
Layouts are the JAX package's: NCHW activations, OIHW conv weights;
dims and indices are 1-based.  Where JAX's behaviour differs from its
docstring or from the torch function of the same name, the port copies
the behaviour (``SpatialUpSamplingBilinear``, ``GELU``, ``ArgMax``,
``LookupTable`` on id 0).
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


class Ones(InitializationMethod):
    """JAX :54."""

    def init(self, shape, fan_in, fan_out):
        return np.ones(shape, dtype=np.float32)


class ConstInitMethod(InitializationMethod):
    """Every entry ``value`` (JAX :59)."""

    def __init__(self, value):
        self.value = value

    def init(self, shape, fan_in, fan_out):
        return np.full(shape, self.value, dtype=np.float32)


def _draw(generator, shape, torch_draw, numpy_draw):
    """f32 numpy draw: from ``generator`` (a CPU ``torch.Generator``)
    when one is given, else from the shared ``RandomGenerator.RNG`` in
    the JAX package's order (so seeded models start equal)."""
    if generator is None:
        return numpy_draw(RandomGenerator.RNG).astype(np.float32)
    return torch_draw(torch.empty(tuple(shape), dtype=torch.float32),
                      generator).numpy()


class RandomUniform(InitializationMethod):
    """U(lower, upper), or without bounds the Torch default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (JAX :67).  ``generator``, a CPU
    ``torch.Generator``, draws instead of ``RandomGenerator.RNG``."""

    def __init__(self, lower=None, upper=None,
                 generator: Optional[torch.Generator] = None):
        self.lower, self.upper = lower, upper
        self.generator = generator

    def init(self, shape, fan_in, fan_out):
        if self.lower is None:
            stdv = 1.0 / math.sqrt(max(1, fan_in))
            lo, hi = -stdv, stdv
        else:
            lo, hi = self.lower, self.upper
        return _draw(self.generator, shape,
                     lambda t, g: t.uniform_(lo, hi, generator=g),
                     lambda rng: rng.uniform(lo, hi, size=shape))


class RandomNormal(InitializationMethod):
    """N(mean, stdv²) (JAX :83); ``generator`` as ``RandomUniform``'s."""

    def __init__(self, mean=0.0, stdv=1.0,
                 generator: Optional[torch.Generator] = None):
        self.mean, self.stdv = mean, stdv
        self.generator = generator

    def init(self, shape, fan_in, fan_out):
        return _draw(self.generator, shape,
                     lambda t, g: t.normal_(self.mean, self.stdv,
                                            generator=g),
                     lambda rng: rng.normal(self.mean, self.stdv,
                                            size=shape))


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
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self._set_regularizers((("w_regularizer", w_regularizer, ("weight",)),
                                ("b_regularizer", b_regularizer, ("bias",))))
        self._init_method = init_method or Xavier()
        self.reset()

    def reset(self):
        """The weight drawn again by the init method, the bias zeroed
        (JAX :167)."""
        self._set_param("weight", self._init_method.init(
            (self.output_size, self.input_size), self.input_size,
            self.output_size))
        self._set_param("bias", np.zeros(self.output_size, np.float32)
                        if self.with_bias else None)
        return self

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
    itself is not rewritten, unlike ``F.embedding(max_norm=...)``).
    Out of range as JAX's ``jnp.take``: id 0 (the text pipeline's
    padding) and the ids below it count from the end, so id 0 reads the
    last row; an id outside [1 - n, n] reads NaN and no gradient."""

    config_names = ("n_index", "n_output", "padding_value")

    param_names = ("weight",)

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0, max_norm: float = float("inf"),
                 norm_type: float = 2.0, w_regularizer=None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self._set_regularizers((("w_regularizer", w_regularizer,
                                 ("weight",)),))
        self.reset()

    def reset(self):
        w = RandomGenerator.RNG.normal(
            0.0, 1.0, size=(self.n_index, self.n_output)).astype(np.float32)
        if self.padding_value > 0:
            w[int(self.padding_value) - 1] = 0.0
        self._set_param("weight", w)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        n = w.shape[0]
        idx = x.long() - 1
        valid = (idx >= -n) & (idx < n)
        idx = torch.where(valid, torch.remainder(idx, n), 0)
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = w * torch.clamp_max(self.max_norm / (norms + 1e-7), 1.0)
        out = F.embedding(idx, w)
        return torch.where(valid[..., None], out, out.new_tensor(float("nan")))

    def extra_repr(self):
        return f"{self.n_index}, {self.n_output}"


def _auto_batch(x, full_ndim):
    if x.dim() == full_ndim - 1:
        return x[None], True
    return x, False


def dropout(x: torch.Tensor, p: float, seed: int,
            scale: bool = True) -> torch.Tensor:
    """``where(mask, x / keep, 0)`` with keep = 1 − p (no ``/ keep``
    without ``scale``) and the mask drawn with probability keep from a
    generator seeded with ``seed`` on x's device (JAX ``bernoulli(rng,
    keep)``; other bits than JAX's).  The generator is made inside the
    call, so a forward that ``torch.utils.checkpoint`` runs again draws
    the same mask, and no global RNG state is read."""
    keep = 1.0 - p
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep if scale else x, torch.zeros_like(x))


def same_pads(in_size: int, k: int, s: int) -> tuple:
    """XLA's SAME padding of one spatial dim: ``max((ceil(in/s) - 1)·s
    + k - in, 0)`` cells in all, the odd one at the high end."""
    return _pool_pad(in_size, k, s, -1, False)[1]


def conv2d_same(x, w, b, stride, groups: int = 1):
    """``F.conv2d`` with XLA's SAME padding (JAX ``padding="SAME"``):
    symmetric pads go to the conv, an odd total through ``F.pad``."""
    ph = same_pads(x.shape[2], w.shape[2], stride[0])
    pw = same_pads(x.shape[3], w.shape[3], stride[1])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b,
                    stride=stride, groups=groups)


class SpatialConvolution(AbstractModule):
    """2-D convolution over NCHW input (JAX :261), width-first argument
    order as in the reference.  Symmetric zero padding, or with
    ``pad_w`` or ``pad_h`` at -1 TF-style SAME on both dims (JAX
    ``_conv_pads``, :253-258): ``conv2d_same``.  Runs ``F.conv2d``
    (cuDNN on the card): the JAX package leaves this conv to XLA."""

    config_names = ("n_input_plane", "n_output_plane", "kernel_w",
                    "kernel_h", "stride_w", "stride_h", "pad_w", "pad_h",
                    "n_group", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        self._set_regularizers((("w_regularizer", w_regularizer, ("weight",)),
                                ("b_regularizer", b_regularizer, ("bias",))))
        self._init_method = init_method or MsraFiller(False)
        self.reset()

    def reset(self):
        """JAX :318."""
        g, kh, kw = self.n_group, self.kernel_h, self.kernel_w
        self._set_param("weight", self._init_method.init(
            (self.n_output_plane, self.n_input_plane // g, kh, kw),
            self.n_input_plane // g * kh * kw,
            self.n_output_plane // g * kh * kw))
        self._set_param("bias", np.zeros(self.n_output_plane, np.float32)
                        if self.with_bias else None)
        return self

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        stride = (self.stride_h, self.stride_w)
        if self.pad_h == -1 or self.pad_w == -1:
            y = conv2d_same(x, self.weight, self.bias, stride, self.n_group)
        else:
            y = F.conv2d(x, self.weight, self.bias, stride=stride,
                         padding=(self.pad_h, self.pad_w),
                         groups=self.n_group)
        return y[0] if squeezed else y

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.stride_w},"
                f"{self.stride_h}, {self.pad_w},{self.pad_h}")


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous 2-D convolution (JAX :368): the kernel's taps
    ``dilation`` apart."""

    config_names = SpatialConvolution.config_names + ("dilation_w",
                                                      "dilation_h")

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, dilation_w=1,
                 dilation_h=1, **kw):
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h, **kw)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        y = F.conv2d(x, self.weight, self.bias,
                     stride=(self.stride_h, self.stride_w),
                     padding=(self.pad_h, self.pad_w),
                     dilation=(self.dilation_h, self.dilation_w),
                     groups=self.n_group)
        return y[0] if squeezed else y


class SpatialFullConvolution(AbstractModule):
    """Transposed convolution (JAX :416): out = (in − 1)·stride − 2·pad
    + kernel + adj.  The weight is JAX's ``(out, in/group, kh, kw)``;
    ``F.conv_transpose2d`` takes ``(in, out/group, kh, kw)``, and
    ``_transposed_weight`` maps one onto the other: group g's block of
    ``out/group`` rows, its (o, i) tap, becomes row ``g·in/group + i``,
    column o.  JAX runs the same function as a conv over the input
    dilated by the stride with the kernel flipped; both sum the same
    products."""

    config_names = ("n_input_plane", "n_output_plane", "kernel_w",
                    "kernel_h", "stride_w", "stride_h", "pad_w", "pad_h",
                    "adj_w", "adj_h", "n_group", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, adj_w=0, adj_h=0,
                 n_group=1, with_bias=True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = with_bias
        self._init_method = init_method or MsraFiller(False)
        self.reset()

    def reset(self):
        """JAX :466."""
        kh, kw = self.kernel_h, self.kernel_w
        self._set_param("weight", self._init_method.init(
            (self.n_output_plane, self.n_input_plane // self.n_group, kh,
             kw), self.n_input_plane * kh * kw,
            self.n_output_plane * kh * kw))
        self._set_param("bias", np.zeros(self.n_output_plane, np.float32)
                        if self.with_bias else None)
        return self

    def _transposed_weight(self):
        g = self.n_group
        o, i, kh, kw = self.weight.shape
        return self.weight.reshape(g, o // g, i, kh, kw).transpose(
            1, 2).reshape(g * i, o // g, kh, kw)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        w = self._transposed_weight()
        stride = (self.stride_h, self.stride_w)
        pad = (self.pad_h, self.pad_w)
        adj = (self.adj_h, self.adj_w)
        # torch's output padding must stay below the stride and JAX's
        # adj need not: take the whole transposed conv, zero-extend it by
        # what adj reaches past it, and crop ``pad`` off the front
        full = F.conv_transpose2d(x, w, None, stride, 0, 0, self.n_group)
        ho = (x.shape[2] - 1) * stride[0] - 2 * pad[0] + self.kernel_h + adj[0]
        wo = (x.shape[3] - 1) * stride[1] - 2 * pad[1] + self.kernel_w + adj[1]
        full = F.pad(full, (0, max(0, adj[1] - pad[1]),
                            0, max(0, adj[0] - pad[0])))
        y = full[:, :, pad[0]:pad[0] + ho, pad[1]:pad[1] + wo]
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y[0] if squeezed else y


class TemporalConvolution(AbstractModule):
    """1-D convolution over (N, T, C_in) frames, no padding (JAX :518):
    the text CNN's conv.  The weight is JAX's ``(out, in, kW)``, which
    is ``F.conv1d``'s layout on the (N, C, T) frame.  The JAX spec has
    no ``with_bias`` (its ``_config`` leaves it out); the port's records
    it only when it is False, so a biased layer's spec stays JAX's."""

    config_names = ("input_frame_size", "output_frame_size", "kernel_w",
                    "stride_w")

    param_names = ("weight", "bias")

    def __init__(self, input_frame_size, output_frame_size, kernel_w,
                 stride_w=1, with_bias=True, init_method=None):
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        self._init_method = init_method or Xavier()
        self.reset()

    def reset(self):
        """JAX :548."""
        n_in, n_out, kw = (self.input_frame_size, self.output_frame_size,
                           self.kernel_w)
        self._set_param("weight", self._init_method.init(
            (n_out, n_in, kw), n_in * kw, n_out * kw))
        self._set_param("bias", np.zeros(n_out, np.float32)
                        if self.with_bias else None)
        return self

    def get_config(self):
        out = super().get_config()
        if not self.with_bias:
            out["with_bias"] = False
        return out

    def forward(self, x):
        x, squeezed = _auto_batch(x, 3)
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     stride=self.stride_w).transpose(1, 2)
        return y[0] if squeezed else y

    def extra_repr(self):
        return (f"{self.input_frame_size} -> {self.output_frame_size}, "
                f"{self.kernel_w}, {self.stride_w}")


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

    def ceil(self):
        """Round the output size up (Caffe's pooling); returns self."""
        self.ceil_mode = True
        return self

    def floor(self):
        """Round the output size down (the default); returns self."""
        self.ceil_mode = False
        return self

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

    ceil = SpatialMaxPooling.ceil
    floor = SpatialMaxPooling.floor

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


class SoftMax(AbstractModule):
    """Softmax over the last (class) dim (JAX :782)."""

    def forward(self, x):
        return torch.softmax(x, dim=-1)


class SoftPlus(AbstractModule):
    """``log(1 + exp(beta·x)) / beta`` (JAX :800)."""

    config_names = ("beta",)

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return torch.logaddexp(self.beta * x, x.new_zeros(())) / self.beta


class ELU(AbstractModule):
    """``x`` above 0, ``alpha·(exp(x) − 1)`` below (JAX :821)."""

    config_names = ("alpha",)

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self.alpha)


class LeakyReLU(AbstractModule):
    """``x`` at or above 0, ``negval·x`` below (JAX :834)."""

    config_names = ("negval",)

    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def forward(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class PReLU(AbstractModule):
    """Leaky ReLU with a learned slope (JAX :884), one shared
    (``n_output_plane`` 0) or one per channel (the dim 3 from the end,
    NCHW's C), starting at 0.25."""

    config_names = ("n_output_plane",)

    param_names = ("weight",)

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane
        self._set_param("weight", np.full(max(1, n_output_plane), 0.25,
                                          dtype=np.float32))

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0 and x.dim() >= 3:
            shape = [1] * x.dim()
            shape[-3] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x > 0, x, w * x)


class Abs(AbstractModule):
    """JAX :932."""

    def forward(self, x):
        return torch.abs(x)


class Power(AbstractModule):
    """``(shift + scale·x) ** power`` (JAX :953)."""

    config_names = ("power", "scale", "shift")

    def __init__(self, power, scale=1.0, shift=0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return (self.shift + self.scale * x) ** self.power


class Log(AbstractModule):
    """JAX :964."""

    def forward(self, x):
        return torch.log(x)


class Exp(AbstractModule):
    """JAX :971."""

    def forward(self, x):
        return torch.exp(x)


class Scale(AbstractModule):
    """``x · weight + bias``, both of shape ``size`` broadcast against x
    (JAX :1169; Caffe's Scale layer): weight ones, bias zeros."""

    config_names = ("size",)

    param_names = ("weight", "bias")

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self._set_param("weight", np.ones(self.size, np.float32))
        self._set_param("bias", np.zeros(self.size, np.float32))

    def forward(self, x):
        return x * self.weight + self.bias


class SpatialCrossMapLRN(AbstractModule):
    """Local response normalization across channels (JAX :1394):
    ``x · (k + alpha/size · Σ x²)^(−beta)``, the sum over a window of
    ``size`` channels, ``(size − 1) // 2`` of them before the channel
    (``F.local_response_norm`` puts ``size // 2`` before it, which
    differs at an even size)."""

    config_names = ("size", "alpha", "beta", "k")

    def __init__(self, size=5, alpha=1.0, beta=0.75, k=1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        c = x.shape[1]
        half = (self.size - 1) // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, self.size - 1 - half))
        summed = sq[:, 0:c]
        for i in range(1, self.size):
            summed = summed + sq[:, i:i + c]
        y = x * (self.k + self.alpha / self.size * summed) ** (-self.beta)
        return y[0] if squeezed else y


class Dropout(AbstractModule):
    """Inverted dropout (JAX :1425): in training, given a seed
    (``forward(x, rng_seed)``, handed out by the containers as
    ``fold_in(seed, child index)``), zero each element with probability
    ``p`` and scale the rest by 1 / (1 − p) (unless ``scale=False``);
    the identity in eval mode or without a seed.  The mask comes from
    ``dropout``'s generator, so its bits differ from JAX's."""

    config_names = ("init_p", "scale")

    takes_rng_seed = True

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.init_p = init_p
        self.p = init_p
        self.scale = scale

    def forward(self, x, rng_seed: Optional[int] = None):
        if not self.training or self.p <= 0.0 or rng_seed is None:
            return x
        return dropout(x, self.p, rng_seed, self.scale)


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


# ---- elementwise layers (JAX :750-1108) -------------------------------------
def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, so that a tie at a
    bound splits the gradient as ``jnp.maximum``/``jnp.minimum`` do
    (``torch.clamp`` gives it all to x)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class ReLU6(AbstractModule):
    """``clip(x, 0, 6)`` (JAX :750)."""

    def forward(self, x):
        return _clip(x, 0.0, 6.0)


class HardTanh(AbstractModule):
    """``clip(x, min_value, max_value)`` (JAX :847)."""

    config_names = ("min_value", "max_value")

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace=False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return _clip(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    """``HardTanh`` with both bounds required (JAX :865)."""

    def __init__(self, min_value, max_value):
        super().__init__(min_value, max_value)


class HardSigmoid(AbstractModule):
    """``clip(0.2·x + 0.5, 0, 1)`` (JAX :858)."""

    def forward(self, x):
        return _clip(0.2 * x + 0.5, 0.0, 1.0)


class Threshold(AbstractModule):
    """``x`` where x > ``th``, else ``v`` (JAX :872)."""

    config_names = ("th", "v")

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, x.new_tensor(self.v))


class SoftMin(AbstractModule):
    """Softmax of −x over the last dim (JAX :791)."""

    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class SoftSign(AbstractModule):
    """``x / (1 + |x|)`` (JAX :813)."""

    def forward(self, x):
        return x / (1 + torch.abs(x))


class GELU(AbstractModule):
    """``jax.nn.gelu`` (JAX :908), whose default is the tanh
    approximation: ``F.gelu(approximate="tanh")`` (the exact erf form is
    some 4e-4 away from it)."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


class SELU(AbstractModule):
    """Scaled ELU with Klambauer et al.'s fixed constants (JAX :917)."""

    def forward(self, x):
        return F.selu(x)


class Square(AbstractModule):
    """``x · x`` (JAX :939)."""

    def forward(self, x):
        return x * x


def _unary(name: str, fn, line: int):
    """An elementwise layer class that applies ``fn``."""
    def forward(self, x):
        return fn(x)

    return type(name, (AbstractModule,), {
        "__doc__": f"``torch.{fn.__name__}`` elementwise (JAX :{line}).",
        "__module__": __name__, "forward": forward})


Sqrt = _unary("Sqrt", torch.sqrt, 946)
Negative = _unary("Negative", torch.neg, 978)
Floor = _unary("Floor", torch.floor, 985)
Ceil = _unary("Ceil", torch.ceil, 992)
Round = _unary("Round", torch.round, 999)     # half to even, as jnp.round
Sign = _unary("Sign", torch.sign, 1006)
Log1p = _unary("Log1p", torch.log1p, 1013)
Expm1 = _unary("Expm1", torch.expm1, 1020)
Erf = _unary("Erf", torch.erf, 1027)
Sin = _unary("Sin", torch.sin, 1036)
Cos = _unary("Cos", torch.cos, 1043)


class ArgMax(AbstractModule):
    """The index of the largest entry along the 1-based ``dim`` (counting
    the batch axis; a negative one counts from the end), as float32
    (JAX :1050): 0-based, as the JAX code gives it (its docstring's
    "1-based" is the dim's), the first of tied maxima.  No gradient."""

    config_names = ("dim",)

    def __init__(self, dim=1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        axis = self.dim - 1 if self.dim > 0 else self.dim
        return torch.argmax(x, dim=axis).to(torch.float32)


class AddConstant(AbstractModule):
    """``x + constant_scalar`` (JAX :1067)."""

    config_names = ("constant_scalar",)

    def __init__(self, constant_scalar, inplace=False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class DivConstant(AbstractModule):
    """``x / constant_scalar``, a true division (JAX :1078)."""

    config_names = ("constant_scalar",)

    def __init__(self, constant_scalar):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x / self.constant_scalar


class MulConstant(AbstractModule):
    """``x · scalar`` (JAX :1094)."""

    config_names = ("scalar",)

    def __init__(self, scalar, inplace=False):
        super().__init__()
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar


# ---- learnable elementwise and similarity layers ----------------------------
class CMul(AbstractModule):
    """``x · weight``, the weight of shape ``size`` (ones) broadcast
    against x (JAX :1110)."""

    config_names = ("size",)

    param_names = ("weight",)

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self._set_param("weight", np.ones(self.size, np.float32))

    def forward(self, x):
        return x * self.weight


class CAdd(AbstractModule):
    """``x + bias``, the bias of shape ``size`` (zeros) (JAX :1125)."""

    config_names = ("size",)

    param_names = ("bias",)

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self._set_param("bias", np.zeros(self.size, np.float32))

    def forward(self, x):
        return x + self.bias


class Add(AbstractModule):
    """``x + bias`` over the last dim (JAX :1140)."""

    config_names = ("input_size",)

    param_names = ("bias",)

    def __init__(self, input_size: int):
        super().__init__()
        self.input_size = input_size
        self._set_param("bias", np.zeros(input_size, np.float32))

    def forward(self, x):
        return x + self.bias


class Mul(AbstractModule):
    """``x · w`` with one learned scalar from U(-1, 1) (JAX :1154)."""

    param_names = ("weight",)

    def __init__(self):
        super().__init__()
        self._set_param("weight", RandomGenerator.RNG.uniform(
            -1, 1, size=(1,)).astype(np.float32))

    def forward(self, x):
        return x * self.weight[0]


def _uniform_weight(input_size, shape):
    stdv = 1.0 / math.sqrt(input_size)
    return RandomGenerator.RNG.uniform(-stdv, stdv, size=shape).astype(
        np.float32)


class Cosine(AbstractModule):
    """Cosine similarity of x to each row of the (out, in) weight (JAX
    :1854), each side divided by its L2 norm + 1e-12."""

    config_names = ("input_size", "output_size")

    param_names = ("weight",)

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self._set_param("weight", _uniform_weight(
            input_size, (output_size, input_size)))

    def forward(self, x):
        w = self.weight
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return torch.matmul(xn, wn.t())


class Euclidean(AbstractModule):
    """``sqrt(Σ (x − w_k)² + 1e-12)`` to each row w_k of the (out, in)
    weight (JAX :1878)."""

    config_names = ("input_size", "output_size")

    param_names = ("weight",)

    def __init__(self, input_size: int, output_size: int,
                 fast_backward=True):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self._set_param("weight", _uniform_weight(
            input_size, (output_size, input_size)))

    def forward(self, x):
        diff = x[..., None, :] - self.weight
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


class Bilinear(AbstractModule):
    """``y_k = x1ᵀ W_k x2 + b_k`` over the table (x1, x2) (JAX :1900);
    W is (out, in1, in2)."""

    config_names = ("input_size1", "input_size2", "output_size", "bias_res")

    param_names = ("weight", "bias")

    def __init__(self, input_size1, input_size2, output_size,
                 bias_res=True):
        super().__init__()
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size, self.bias_res = output_size, bias_res
        self._set_param("weight", _uniform_weight(
            input_size1, (output_size, input_size1, input_size2)))
        self._set_param("bias", np.zeros(output_size, np.float32)
                        if bias_res else None)

    def forward(self, xs):
        x1, x2 = xs
        y = torch.einsum("bi,kij,bj->bk", x1, self.weight, x2)
        return y + self.bias if self.bias is not None else y


class Normalize(AbstractModule):
    """``x / (‖x‖_p + eps)``, the norm along dim 1 (JAX :1376); p = inf
    takes the largest |x|."""

    config_names = ("p", "eps")

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == float("inf"):
            norm = torch.amax(torch.abs(x), dim=1, keepdim=True)
        else:
            norm = torch.sum(torch.abs(x) ** self.p, dim=1,
                             keepdim=True) ** (1.0 / self.p)
        return x / (norm + self.eps)


# ---- shape ops (JAX :1519-1765) ---------------------------------------------
class Squeeze(AbstractModule):
    """Drop the 1-based ``dim`` (every size-1 dim without one) (JAX
    :1519)."""

    config_names = ("dim",)

    def __init__(self, dim: Optional[int] = None, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.squeeze(x) if self.dim is None else x.squeeze(
            self.dim - 1)


class Unsqueeze(AbstractModule):
    """Insert a size-1 dim at the 1-based ``pos`` (JAX :1534)."""

    config_names = ("pos",)

    def __init__(self, pos: int, num_input_dims: int = 0):
        super().__init__()
        self.pos = pos

    def forward(self, x):
        return x.unsqueeze(self.pos - 1)


class Transpose(AbstractModule):
    """Swap each 1-based (dim1, dim2) pair in turn (JAX :1546)."""

    config_names = ("permutations",)

    def __init__(self, permutations: Sequence[Sequence[int]]):
        super().__init__()
        self.permutations = [[int(d) for d in p] for p in permutations]

    def forward(self, x):
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x


class Contiguous(AbstractModule):
    """``x.contiguous()``: the identity in value (JAX :1563)."""

    def forward(self, x):
        return x.contiguous()


class Replicate(AbstractModule):
    """``n_features`` copies along a new 1-based ``dim`` (JAX :1571)."""

    config_names = ("n_features", "dim")

    def __init__(self, n_features: int, dim: int = 1,
                 n_dim: int = float("inf")):
        super().__init__()
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        y = x.unsqueeze(self.dim - 1)
        reps = [1] * y.dim()
        reps[self.dim - 1] = self.n_features
        return y.repeat(reps)


class Narrow(AbstractModule):
    """``length`` entries from the 1-based ``offset`` along the 1-based
    ``dim`` (a negative dim counts from the end; a negative length
    leaves ``-length - 1`` entries off the end) (JAX :1587)."""

    config_names = ("dim", "offset", "length")

    def __init__(self, dim: int, offset: int, length: int = 1):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        d = self.dim - 1 if self.dim > 0 else x.dim() + self.dim
        length = self.length
        if length < 0:
            length = x.shape[d] - self.offset + 2 + length
        return x.narrow(d, self.offset - 1, length)


class Padding(AbstractModule):
    """``|pad|`` cells of ``value`` after (pad > 0) or before (pad < 0)
    the 1-based ``dim``, shifted by one when x has more dims than
    ``n_input_dim`` (a batch) (JAX :1606)."""

    config_names = ("dim", "pad", "n_input_dim", "value")

    def __init__(self, dim, pad, n_input_dim, value=0.0, n_index=1):
        super().__init__()
        self.dim, self.pad, self.n_input_dim = dim, pad, n_input_dim
        self.value = value

    def forward(self, x):
        d = self.dim - 1 + (1 if x.dim() > self.n_input_dim else 0)
        pads = [0] * (2 * x.dim())
        pads[2 * (x.dim() - 1 - d) + (0 if self.pad < 0 else 1)] = abs(
            self.pad)
        return F.pad(x, pads, value=self.value)


class SpatialZeroPadding(AbstractModule):
    """Zero-pad the last two (H, W) dims (JAX :1625); each side defaults
    to ``pad_left``."""

    config_names = ("pad_left", "pad_right", "pad_top", "pad_bottom")

    def __init__(self, pad_left, pad_right=None, pad_top=None,
                 pad_bottom=None):
        super().__init__()
        self.pad_left = pad_left
        self.pad_right = pad_left if pad_right is None else pad_right
        self.pad_top = pad_left if pad_top is None else pad_top
        self.pad_bottom = pad_left if pad_bottom is None else pad_bottom

    def forward(self, x):
        return F.pad(x, (self.pad_left, self.pad_right, self.pad_top,
                         self.pad_bottom))


class SpatialUpSamplingNearest(AbstractModule):
    """Each pixel repeated ``scale`` times along H and W (JAX :1648)."""

    config_names = ("scale",)

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        y = torch.repeat_interleave(x, self.scale, dim=-2)
        return torch.repeat_interleave(y, self.scale, dim=-1)


class SpatialUpSamplingBilinear(AbstractModule):
    """Resize NCHW to (output_height, output_width) as the JAX layer
    does (JAX :1662): its docstring says ``align_corners=true``, but it
    runs ``jax.image.resize(..., "linear")``, half-pixel sampling that
    antialiases along a dim it shrinks.  So ``F.interpolate(bilinear,
    align_corners=False)``, with ``antialias`` when a dim shrinks (up
    and down within 2.4e-7 and 1.2e-7 of JAX; ``align_corners=True`` is
    0.67 off, and a shrink without antialias 0.84)."""

    config_names = ("output_height", "output_width")

    def __init__(self, output_height: int, output_width: int):
        super().__init__()
        self.output_height, self.output_width = output_height, output_width

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        size = (self.output_height, self.output_width)
        shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
        y = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=shrink)
        return y[0] if squeezed else y


class Mean(AbstractModule):
    """Mean over the 1-based ``dim`` (shifted by one when x has more
    dims than a positive ``n_input_dims``), squeezed by default (JAX
    :1681)."""

    config_names = ("dim", "n_input_dims", "squeeze")

    def __init__(self, dim: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dim, self.n_input_dims, self.squeeze = dim, n_input_dims, squeeze

    def _axis(self, x):
        d = self.dim - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return d

    def forward(self, x):
        return torch.mean(x, dim=self._axis(x), keepdim=not self.squeeze)


class Sum(Mean):
    """Sum over the dim of ``Mean``, divided by its size with
    ``size_average`` (JAX :1699)."""

    config_names = Mean.config_names + ("size_average",)

    def __init__(self, dim=1, n_input_dims=-1, size_average=False,
                 squeeze=True):
        super().__init__(dim, n_input_dims, squeeze)
        self.size_average = size_average

    def forward(self, x):
        ax = self._axis(x)
        y = torch.sum(x, dim=ax, keepdim=not self.squeeze)
        return y / x.shape[ax] if self.size_average else y


class Max(AbstractModule):
    """The largest value along the 1-based ``dim`` (JAX :1716).
    ``torch.amax`` splits the gradient among tied maxima as ``jnp.max``
    does ([1, 1, 0] gives [.5, .5, 0]; ``torch.max(dim)`` gives it all
    to one): the text CNN's ``Max(2)`` reads a ReLU output, where a
    channel dead over a whole document is all tied zeros.  The JAX spec
    has no ``num_input_dims`` (unused there and here); the port's
    records it only when it is not -1."""

    config_names = ("dim",)
    _reduce = staticmethod(torch.amax)

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def get_config(self):
        out = super().get_config()
        if self.num_input_dims != -1:
            out["num_input_dims"] = self.num_input_dims
        return out

    def forward(self, x):
        return self._reduce(x, dim=self.dim - 1)


class Min(Max):
    """The smallest value, as ``Max`` (JAX :1728)."""

    _reduce = staticmethod(torch.amin)


class Index(AbstractModule):
    """``t`` at the 1-based indices ``idx`` along the 1-based
    ``dimension``, over the table (t, idx) (JAX :1740, ``jnp.take``: the
    index's shape takes the dim's place)."""

    config_names = ("dimension",)

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, xs):
        t, idx = xs
        d = self.dimension - 1
        flat = t.index_select(d, idx.reshape(-1).long() - 1)
        return flat.reshape(tuple(t.shape[:d]) + tuple(idx.shape)
                            + tuple(t.shape[d + 1:]))


class Masking(AbstractModule):
    """Zero each timestep (last-dim vector) whose entries all equal
    ``mask_value`` (JAX :1754)."""

    config_names = ("mask_value",)

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))


# ---- gradient-shaping layers (JAX :1773-1846) -------------------------------
class _GradientReversalFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(AbstractModule):
    """The identity forward, ``-the_lambda · g`` backward (JAX :1790;
    the domain-adaptation trick)."""

    config_names = ("the_lambda",)

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def set_lambda(self, lam):
        self.the_lambda = lam
        return self

    def forward(self, x):
        return _GradientReversalFn.apply(x, self.the_lambda)


class _L1PenaltyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        ctx.w = w
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.w * torch.sign(x), None


class L1Penalty(AbstractModule):
    """The identity forward that adds ``l1weight · sign(x)`` to the
    gradient on the way back, ``l1weight / numel`` with
    ``size_average`` (JAX :1829)."""

    config_names = ("l1weight", "size_average")

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output=True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def forward(self, x):
        w = self.l1weight
        if self.size_average:
            w = w / x.numel()
        return _L1PenaltyFn.apply(x, w)


__all__ = ["InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller", "Linear",
           "LookupTable", "SpatialConvolution", "SpatialDilatedConvolution",
           "SpatialFullConvolution", "TemporalConvolution",
           "SpatialMaxPooling", "SpatialAveragePooling", "ReLU", "ReLU6",
           "Tanh", "Sigmoid", "LogSoftMax", "SoftMax", "SoftMin", "SoftPlus",
           "SoftSign", "ELU", "LeakyReLU", "HardTanh", "HardSigmoid",
           "Clamp", "Threshold", "PReLU", "GELU", "SELU", "Abs", "Square",
           "Sqrt", "Power", "Log", "Exp", "Negative", "Floor", "Ceil",
           "Round", "Sign", "Log1p", "Expm1", "Erf", "Sin", "Cos", "ArgMax",
           "AddConstant", "MulConstant", "DivConstant", "CMul", "CAdd",
           "Add", "Mul", "Scale", "SpatialCrossMapLRN", "Dropout", "dropout",
           "BatchNormalization", "SpatialBatchNormalization", "Normalize",
           "Reshape", "View", "Squeeze", "Unsqueeze", "Transpose",
           "Contiguous", "Replicate", "Narrow", "Padding",
           "SpatialZeroPadding", "SpatialUpSamplingNearest",
           "SpatialUpSamplingBilinear", "Mean", "Sum", "Max", "Min", "Index",
           "Masking", "GradientReversal", "L1Penalty", "Cosine", "Euclidean",
           "Bilinear", "fold_bn", "normalize", "running_update", "same_pads",
           "conv2d_same"]
