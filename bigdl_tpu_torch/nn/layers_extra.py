"""The long-tail layer families of the port.

Counterpart of ``bigdl_tpu/nn/layers_extra.py`` (46 classes): the
locally connected, separable and mapped convolutions (:55-407), the
temporal pools (:409, :437), the shrinks and ``LogSigmoid``, the noise
layers and spatial dropouts (:527-656), cropping, upsampling and the
resizes (:663-836), the spatial normalizations (:848-958), the shape
and TF-vocabulary utilities (:961-1159), and ``MaskedSelect``,
``PairwiseDistance``, ``Maxout``, ``Highway``, ``SReLU``,
``RoiPooling`` and ``NegativeEntropyPenalty`` (:1161-1455).  Specs
(``config_names``) and parameter layouts are the JAX package's, so
``load_jax_params`` and the serializers carry every class across.

Where JAX runs a lax primitive, the port runs its torch counterpart:
``lax.conv_general_dilated_local`` becomes ``F.unfold`` and an einsum
over the unshared weights (both order a patch's features channel
first, then the kernel rows and columns), ``lax.reduce_window`` a pool
or padded sum.  The random layers draw from a generator seeded with
the step's dropout seed (``forward(x, rng_seed)``, as ``Dropout``), so
their bits differ from JAX's; without a seed, or in eval mode, each is
JAX's deterministic map.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.nn.layers import (InitializationMethod, MsraFiller,
                                       SpatialConvolution, Xavier,
                                       _auto_batch, conv2d_same)
from bigdl_tpu_torch.nn.module import AbstractModule


def _generator(seed: int, device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device``, made inside the
    call (as ``dropout()``'s), so a recomputed forward draws the same
    numbers and no global RNG state is read."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _uniform(seed, shape, lo, hi, like):
    gen = _generator(seed, like.device)
    u = torch.rand(tuple(shape), generator=gen, device=like.device)
    return (lo + (hi - lo) * u).to(like.dtype)


def _normal(seed, shape, like):
    gen = _generator(seed, like.device)
    return torch.randn(tuple(shape), generator=gen,
                       device=like.device).to(like.dtype)


# --------------------------------------------------------------------------
# Convolution variants
# --------------------------------------------------------------------------


class LocallyConnected1D(AbstractModule):
    """Temporal conv with unshared kernels, one a output frame (JAX
    :55): input (B, T, F), weight ``(T_out, kW·F_in, F_out)`` (a
    window's frames major, features minor), bias ``(T_out, F_out)``."""

    config_names = ("n_input_frame", "input_frame_size",
                    "output_frame_size", "kernel_w", "stride_w",
                    "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        self.n_output_frame = (n_input_frame - kernel_w) // stride_w + 1
        self._init_method = init_method or Xavier()
        self.reset()

    def reset(self):
        """JAX :92."""
        n_in, n_out, kw = (self.input_frame_size, self.output_frame_size,
                           self.kernel_w)
        self._set_param("weight", self._init_method.init(
            (self.n_output_frame, kw * n_in, n_out), n_in * kw, n_out * kw))
        self._set_param("bias", np.zeros(
            (self.n_output_frame, n_out), np.float32)
            if self.with_bias else None)
        return self

    def forward(self, x):
        x, squeezed = _auto_batch(x, 3)
        # (B, T_out, F_in, kW) -> (B, T_out, kW·F_in), frames major
        win = x.unfold(1, self.kernel_w, self.stride_w)[:, :self.n_output_frame]
        win = win.transpose(2, 3).reshape(x.shape[0], self.n_output_frame, -1)
        y = torch.einsum("btk,tko->bto", win, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None]
        return y[0] if squeezed else y


class LocallyConnected2D(AbstractModule):
    """2-D conv with unshared kernels, one an output position (JAX
    :136), over NCHW.  The weight is JAX's ``conv_general_dilated_local``
    rhs (:180): ``(O, I·kh·kw, out_h, out_w)``, a patch's features
    channel first; ``F.unfold`` orders its columns the same way, and an
    einsum contracts each position's patch with its own kernel."""

    config_names = ("n_input_plane", "input_width", "input_height",
                    "n_output_plane", "kernel_w", "kernel_h", "stride_w",
                    "stride_h", "pad_w", "pad_h", "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int, kernel_w: int,
                 kernel_h: int, stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.input_width, self.input_height = input_width, input_height
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.with_bias = with_bias
        self.out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        self.out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        self._init_method = init_method or Xavier()
        self.reset()

    def reset(self):
        """JAX :177."""
        area = self.kernel_h * self.kernel_w
        k = self.n_input_plane * area
        self._set_param("weight", self._init_method.init(
            (self.n_output_plane, k, self.out_h, self.out_w),
            k, self.n_output_plane * area))
        self._set_param("bias", np.zeros(
            (self.n_output_plane, self.out_h, self.out_w), np.float32)
            if self.with_bias else None)
        return self

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        cols = F.unfold(x, (self.kernel_h, self.kernel_w),
                        padding=(self.pad_h, self.pad_w),
                        stride=(self.stride_h, self.stride_w))
        w = self.weight.to(x.dtype).reshape(self.n_output_plane, -1,
                                            self.out_h * self.out_w)
        y = torch.einsum("nkl,okl->nol", cols, w).reshape(
            x.shape[0], self.n_output_plane, self.out_h, self.out_w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None]
        return y[0] if squeezed else y


class SpatialSeparableConvolution(AbstractModule):
    """A depthwise conv (``depth_multiplier`` kernels an input plane,
    ``groups=C``), then a 1x1 pointwise conv (JAX :222); -1 pads are
    SAME on the depthwise conv."""

    config_names = ("n_input_channel", "n_output_channel",
                    "depth_multiplier", "kernel_w", "kernel_h", "stride_w",
                    "stride_h", "pad_w", "pad_h", "with_bias")

    param_names = ("depth_weight", "point_weight", "bias")

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1, pad_w: int = 0,
                 pad_h: int = 0, with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.with_bias = with_bias
        self._init_method = init_method or MsraFiller(False)
        self.reset()

    def reset(self):
        """JAX :263."""
        init = self._init_method
        mid = self.n_input_channel * self.depth_multiplier
        k = self.kernel_h * self.kernel_w
        self._set_param("depth_weight", init.init(
            (mid, 1, self.kernel_h, self.kernel_w),
            self.depth_multiplier * k, self.depth_multiplier * k))
        self._set_param("point_weight", init.init(
            (self.n_output_channel, mid, 1, 1), mid, self.n_output_channel))
        self._set_param("bias", np.zeros(self.n_output_channel, np.float32)
                        if self.with_bias else None)
        return self

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        dw = self.depth_weight.to(x.dtype)
        stride = (self.stride_h, self.stride_w)
        if -1 in (self.pad_h, self.pad_w):
            mid = conv2d_same(x, dw, None, stride, self.n_input_channel)
        else:
            mid = F.conv2d(x, dw, None, stride, (self.pad_h, self.pad_w),
                           groups=self.n_input_channel)
        y = F.conv2d(mid, self.point_weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).reshape(1, -1, 1, 1)
        return y[0] if squeezed else y


class SpatialShareConvolution(SpatialConvolution):
    """``SpatialConvolution`` under the reference's other name (JAX
    :317): the reference shared im2col buffers across replicas; there
    is no such buffer here."""


class SpatialConvolutionMap(AbstractModule):
    """Convolution over a connection table of 1-based (input plane,
    output plane) rows (JAX :325): a full conv whose weight is masked
    by the table (a non-persistent buffer, moved with the module)."""

    config_names = ("conn_table", "kernel_w", "kernel_h", "stride_w",
                    "stride_h", "pad_w", "pad_h")

    param_names = ("weight", "bias")

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1, pad_w: int = 0,
                 pad_h: int = 0,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        conn = np.asarray(conn_table, dtype=np.int64).reshape(-1, 2)
        self.conn_table = conn.tolist()
        self.n_input_plane = int(conn[:, 0].max())
        self.n_output_plane = int(conn[:, 1].max())
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = np.zeros((self.n_output_plane, self.n_input_plane, 1, 1),
                        np.float32)
        mask[conn[:, 1] - 1, conn[:, 0] - 1, 0, 0] = 1.0
        self.register_buffer("_mask", torch.from_numpy(mask),
                             persistent=False)
        self._init_method = init_method or MsraFiller(False)
        self.reset()

    def reset(self):
        """JAX :377: fan-in is an output plane's connections times the
        kernel area."""
        conn = np.asarray(self.conn_table, dtype=np.int64)
        per_out = np.bincount(conn[:, 1] - 1, minlength=self.n_output_plane)
        fan_in = int(per_out.max()) * self.kernel_h * self.kernel_w
        w = self._init_method.init(
            (self.n_output_plane, self.n_input_plane, self.kernel_h,
             self.kernel_w), fan_in, fan_in)
        mask = self._mask.cpu().numpy()
        self._set_param("weight", (w * mask).astype(np.float32))
        self._set_param("bias", np.zeros(self.n_output_plane, np.float32))
        return self

    @staticmethod
    def full(n_in: int, n_out: int):
        """The all-to-all table (the reference's ``full``)."""
        return [[i + 1, o + 1] for o in range(n_out) for i in range(n_in)]

    @staticmethod
    def one_to_one(n: int):
        """The reference's ``oneToOne`` table."""
        return [[i + 1, i + 1] for i in range(n)]

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        w = self.weight.to(x.dtype) * self._mask.to(x.dtype)
        y = F.conv2d(x, w, self.bias.to(x.dtype),
                     (self.stride_h, self.stride_w),
                     (self.pad_h, self.pad_w))
        return y[0] if squeezed else y


class TemporalMaxPooling(AbstractModule):
    """Max pool over the frames of (B, T, F), no padding (JAX :409)."""

    config_names = ("k_w", "d_w")

    def __init__(self, k_w: int, d_w: Optional[int] = None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def forward(self, x):
        x, squeezed = _auto_batch(x, 3)
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w).transpose(
            1, 2)
        return y[0] if squeezed else y


class TemporalAveragePooling(TemporalMaxPooling):
    """Average pool over the frames of (B, T, F), no padding (JAX
    :437): the window's sum over ``k_w``."""

    def forward(self, x):
        x, squeezed = _auto_batch(x, 3)
        y = F.avg_pool1d(x.transpose(1, 2), self.k_w, self.d_w).transpose(
            1, 2)
        return y[0] if squeezed else y


# --------------------------------------------------------------------------
# Shrink-family activations
# --------------------------------------------------------------------------


class SoftShrink(AbstractModule):
    """x ∓ λ outside (−λ, λ), 0 inside (JAX :470)."""

    config_names = ("lambda_",)

    def __init__(self, lambda_: float = 0.5):
        super().__init__()
        self.lambda_ = lambda_

    def forward(self, x):
        lam = self.lambda_
        zero = torch.zeros_like(x)
        return torch.where(x > lam, x - lam,
                           torch.where(x < -lam, x + lam, zero))


class HardShrink(SoftShrink):
    """Identity outside (−λ, λ), 0 inside (JAX :487)."""

    def forward(self, x):
        return torch.where(torch.abs(x) > self.lambda_, x,
                           torch.zeros_like(x))


class TanhShrink(AbstractModule):
    """x − tanh(x) (JAX :503)."""

    def forward(self, x):
        return x - torch.tanh(x)


class LogSigmoid(AbstractModule):
    """log(1 / (1 + exp(−x))) as −softplus(−x) (JAX :510)."""

    def forward(self, x):
        return -torch.logaddexp(-x, x.new_zeros(()))


class RReLU(AbstractModule):
    """Randomized leaky ReLU (JAX :527): in training, given a seed, a
    slope ~ U(lower, upper) an element; else the slope
    (lower + upper) / 2."""

    config_names = ("lower", "upper")

    takes_rng_seed = True

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x, rng_seed: Optional[int] = None):
        if self.training and rng_seed is not None:
            slope = _uniform(rng_seed, x.shape, self.lower, self.upper, x)
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, x * slope)


# --------------------------------------------------------------------------
# Noise layers
# --------------------------------------------------------------------------


class GaussianDropout(AbstractModule):
    """Multiplicative N(1, rate / (1 − rate)) noise in training, given
    a seed; the identity otherwise (JAX :556)."""

    config_names = ("rate",)

    takes_rng_seed = True

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError("rate must be in [0, 1)")
        self.rate = rate

    def forward(self, x, rng_seed: Optional[int] = None):
        if not self.training or rng_seed is None or self.rate == 0.0:
            return x
        std = math.sqrt(self.rate / (1.0 - self.rate))
        return x * (1.0 + std * _normal(rng_seed, x.shape, x))


class GaussianNoise(AbstractModule):
    """Additive N(0, stddev²) noise in training, given a seed; the
    identity otherwise (JAX :577)."""

    config_names = ("stddev",)

    takes_rng_seed = True

    def __init__(self, stddev: float):
        super().__init__()
        self.stddev = stddev

    def forward(self, x, rng_seed: Optional[int] = None):
        if not self.training or rng_seed is None:
            return x
        return x + self.stddev * _normal(rng_seed, x.shape, x)


class GaussianSampler(AbstractModule):
    """The VAE reparameterization (JAX :595): table (mean, log_var) ->
    mean + exp(log_var / 2)·ε with ε ~ N(0, 1) drawn from the seed; the
    mean without one.  As in JAX, a given seed draws in eval mode too."""

    takes_rng_seed = True

    def forward(self, x, rng_seed: Optional[int] = None):
        mean, log_var = x
        if rng_seed is None:
            return mean
        return mean + torch.exp(log_var * 0.5) * _normal(rng_seed,
                                                         mean.shape, mean)


# --------------------------------------------------------------------------
# Spatial dropouts (drop whole feature maps)
# --------------------------------------------------------------------------


class _SpatialDropoutN(AbstractModule):
    _ndim = 4            # batched rank
    _mask_axes: tuple = ()   # axes the mask is constant over

    config_names = ("init_p",)

    takes_rng_seed = True

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.init_p = init_p
        self.p = init_p

    def forward(self, x, rng_seed: Optional[int] = None):
        if not self.training or rng_seed is None or self.p <= 0.0:
            return x
        x, squeezed = _auto_batch(x, self._ndim)
        keep = 1.0 - self.p
        shape = tuple(1 if a in self._mask_axes else s
                      for a, s in enumerate(x.shape))
        gen = _generator(rng_seed, x.device)
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
        y = torch.where(mask, x, torch.zeros_like(x)) / keep
        return y[0] if squeezed else y


class SpatialDropout1D(_SpatialDropoutN):
    """(B, T, C): whole channels dropped, the mask shared over T (JAX
    :616)."""

    _ndim = 3
    _mask_axes = (1,)


class SpatialDropout2D(_SpatialDropoutN):
    """NCHW: whole feature maps dropped (JAX :625)."""

    _ndim = 4
    _mask_axes = (2, 3)


class SpatialDropout3D(_SpatialDropoutN):
    """NCDHW: whole feature volumes dropped (JAX :634)."""

    _ndim = 5
    _mask_axes = (2, 3, 4)


# --------------------------------------------------------------------------
# Cropping / resizing
# --------------------------------------------------------------------------


class Cropping2D(AbstractModule):
    """Crop (top, bottom) and (left, right) cells of NCHW (JAX :663)."""

    config_names = ("height_crop", "width_crop")

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0)):
        super().__init__()
        self.height_crop = tuple(height_crop)
        self.width_crop = tuple(width_crop)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        (t, b), (lo, r) = self.height_crop, self.width_crop
        y = x[:, :, t:x.shape[2] - b, lo:x.shape[3] - r]
        return y[0] if squeezed else y


class UpSampling1D(AbstractModule):
    """Each frame of (B, T, F) ``length`` times (JAX :681)."""

    config_names = ("length",)

    def __init__(self, length: int = 2):
        super().__init__()
        self.length = length

    def forward(self, x):
        x, squeezed = _auto_batch(x, 3)
        y = torch.repeat_interleave(x, self.length, dim=1)
        return y[0] if squeezed else y


class UpSampling2D(AbstractModule):
    """Nearest repeat of NCHW's H and W by ``size`` (JAX :696)."""

    config_names = ("size",)

    def __init__(self, size=(2, 2)):
        super().__init__()
        self.size = tuple(size)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        y = torch.repeat_interleave(
            torch.repeat_interleave(x, self.size[0], 2), self.size[1], 3)
        return y[0] if squeezed else y


def _resize_src_coords(out_size: int, in_size: int, align_corners: bool,
                       half_pixel_centers: bool, device) -> torch.Tensor:
    """Source coordinates of one axis in f32, TF's three conventions
    (JAX :715): legacy ``dst·in/out``, align_corners, half-pixel."""
    d = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        return d * ((in_size - 1.0) / (out_size - 1.0))
    scale = in_size / out_size
    if half_pixel_centers:
        return (d + 0.5) * scale - 0.5
    return d * scale


class _Resize(AbstractModule):
    config_names = ("output_height", "output_width", "align_corners",
                    "half_pixel_centers")

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False,
                 half_pixel_centers: bool = False):
        super().__init__()
        self.output_height, self.output_width = output_height, output_width
        self.align_corners = align_corners
        self.half_pixel_centers = half_pixel_centers

    def _src(self, out_size, in_size, device):
        return _resize_src_coords(out_size, in_size, self.align_corners,
                                  self.half_pixel_centers, device)


class ResizeBilinear(_Resize):
    """Bilinear resize of NCHW (JAX :728) on JAX's own source
    coordinates (``_resize_src_coords``; not ``F.interpolate``'s),
    clipped to the plane, the weights in f32."""

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        h, w = x.shape[2], x.shape[3]
        ys = torch.clamp(self._src(self.output_height, h, x.device),
                         0.0, h - 1.0)
        xs = torch.clamp(self._src(self.output_width, w, x.device),
                         0.0, w - 1.0)
        y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
        y1 = torch.clamp(y0 + 1, 0, h - 1)
        x1 = torch.clamp(x0 + 1, 0, w - 1)
        wy = (ys - y0).reshape(1, 1, -1, 1)
        wx = (xs - x0).reshape(1, 1, 1, -1)

        def g(yy, xx):
            return x.index_select(2, yy).index_select(3, xx)

        top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
        bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
        out = (top * (1 - wy) + bot * wy).to(x.dtype)
        return out[0] if squeezed else out


class ResizeNearestNeighbor(_Resize):
    """Nearest resize of NCHW (JAX :769): with ``align_corners`` the
    source coordinate rounds half to even (``jnp.round``, as
    ``torch.round``), with ``half_pixel_centers`` it is
    ``floor(src + 0.5)`` (TF's nearest scaler omits the −0.5 shift),
    else ``floor(src)``; clipped to the plane."""

    def _indices(self, out_size, in_size, device):
        src = self._src(out_size, in_size, device)
        if self.align_corners:
            idx = torch.round(src)
        elif self.half_pixel_centers:
            idx = torch.floor(src + 0.5)
        else:
            idx = torch.floor(src)
        return torch.clamp(idx.long(), 0, in_size - 1)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        ys = self._indices(self.output_height, x.shape[2], x.device)
        xs = self._indices(self.output_width, x.shape[3], x.device)
        out = x.index_select(2, ys).index_select(3, xs)
        return out[0] if squeezed else out


class DepthToSpace(AbstractModule):
    """TF DepthToSpace (DCR) on NCHW (JAX :801): channel blocks of
    ``block_size²`` onto the spatial grid."""

    config_names = ("block_size",)

    def __init__(self, block_size: int):
        super().__init__()
        self.block_size = block_size

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        n, c, h, w = x.shape
        b = self.block_size
        out = x.reshape(n, b, b, c // (b * b), h, w).permute(
            0, 3, 4, 1, 5, 2).reshape(n, c // (b * b), h * b, w * b)
        return out[0] if squeezed else out


class SpaceToDepth(DepthToSpace):
    """TF SpaceToDepth (DCR) on NCHW, DepthToSpace's inverse (JAX
    :820)."""

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        n, c, h, w = x.shape
        b = self.block_size
        out = x.reshape(n, c, h // b, b, w // b, b).permute(
            0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)
        return out[0] if squeezed else out


# --------------------------------------------------------------------------
# Spatial normalizations
# --------------------------------------------------------------------------


class SpatialWithinChannelLRN(AbstractModule):
    """LRN over a size × size spatial window within each channel (JAX
    :848): x / (1 + α/n · Σ x²)^β, n = size², the window padded
    (size // 2, size − 1 − size // 2) with zeros."""

    config_names = ("size", "alpha", "beta")

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75):
        super().__init__()
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        s, pad = self.size, self.size // 2
        sq = F.pad(x * x, (pad, s - 1 - pad, pad, s - 1 - pad))
        n = s * s
        summed = F.avg_pool2d(sq, s, 1) * n
        y = x / (1.0 + (self.alpha / n) * summed) ** self.beta
        return y[0] if squeezed else y


def _gaussian_kernel2d(size: int) -> np.ndarray:
    """The reference's default smoothing kernel, a normalised gaussian
    (JAX :876)."""
    sigma = 0.25 * size
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class SpatialSubtractiveNormalization(AbstractModule):
    """Subtract the kernel-weighted neighbourhood mean over all planes
    (JAX :885), divided by the same conv over ones at the borders (the
    reference's coefficient map).  The kernel (default a 9 × 9
    gaussian; a 1-D one is its outer product) is normalised by its sum
    times the planes; the spec keeps it as given."""

    config_names = ("n_input_plane", "kernel")

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        k = (np.asarray(kernel, dtype=np.float32)
             if kernel is not None else _gaussian_kernel2d(9))
        if k.ndim == 1:
            k = np.outer(k, k)
        self.n_input_plane = n_input_plane
        self.kernel = k.tolist()
        self.register_buffer("_norm_kernel", torch.from_numpy(
            (k / (k.sum() * n_input_plane)).astype(np.float32)),
            persistent=False)

    def _local_mean(self, x):
        kh, kw = self._norm_kernel.shape
        w = self._norm_kernel.to(device=x.device, dtype=x.dtype).expand(
            1, x.shape[1], kh, kw)
        pads = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
        mean = F.conv2d(F.pad(x, pads), w)
        ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        coef = F.conv2d(F.pad(ones, pads), w)
        return mean / coef

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        y = x - self._local_mean(x)
        return y[0] if squeezed else y


class SpatialDivisiveNormalization(SpatialSubtractiveNormalization):
    """Divide by the neighbourhood standard deviation, floored by its
    mean over the sample (JAX :925)."""

    def forward(self, x):
        x, squeezed = _auto_batch(x, 4)
        sigma = torch.sqrt(torch.clamp_min(self._local_mean(x * x), 0.0))
        thresh = torch.mean(sigma, dim=(1, 2, 3), keepdim=True)
        y = x / torch.maximum(sigma, thresh)
        return y[0] if squeezed else y


class SpatialContrastiveNormalization(SpatialSubtractiveNormalization):
    """Subtractive then divisive normalization with one kernel (JAX
    :940)."""

    def forward(self, x):
        return SpatialDivisiveNormalization.forward(
            self, SpatialSubtractiveNormalization.forward(self, x))


# --------------------------------------------------------------------------
# Shape utilities
# --------------------------------------------------------------------------


def _dim0(dim: int, ndim: int) -> int:
    """A 1-based dim (negative counts from the end) as a 0-based one."""
    return dim - 1 if dim > 0 else ndim + dim


class ExpandSize(AbstractModule):
    """Broadcast singleton dims to ``sizes``; −1 keeps the input's
    (JAX :961)."""

    config_names = ("sizes",)

    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.sizes = list(sizes)

    def forward(self, x):
        target = tuple(s if t == -1 else t
                       for t, s in zip(self.sizes, x.shape))
        return x.expand(target)


class InferReshape(AbstractModule):
    """Reshape where −1 infers a dim and 0 copies the input's; with
    ``batch_mode`` the batch dim is kept in front (JAX :976)."""

    config_names = ("size", "batch_mode")

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = list(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = [in_shape[i] if s == 0 else s for i, s in enumerate(self.size)]
        if self.batch_mode:
            out = [x.shape[0]] + out
        return x.reshape(tuple(out))


class Tile(AbstractModule):
    """``copies`` repeats along 1-based ``dim`` (JAX :999)."""

    config_names = ("dim", "copies")

    def __init__(self, dim: int = 1, copies: int = 2):
        super().__init__()
        self.dim, self.copies = dim, copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[_dim0(self.dim, x.dim())] = self.copies
        return x.repeat(*reps)


class SplitChunks(AbstractModule):
    """TF ``Split``: ``n`` equal chunks along 1-based ``dim``, as a
    table (JAX :1014)."""

    config_names = ("dim", "n")

    def __init__(self, dim: int = 1, n: int = 2):
        super().__init__()
        self.dim, self.n = dim, n

    def forward(self, x):
        d = _dim0(self.dim, x.dim())
        size = x.shape[d]
        if size % self.n:
            raise ValueError(
                f"SplitChunks: dim {self.dim} size {size} not divisible "
                f"into {self.n} chunks")
        return tuple(torch.split(x, size // self.n, dim=d))


class CompareConstant(AbstractModule):
    """Elementwise comparison with a scalar, a bool tensor (JAX
    :1043)."""

    _OPS = ("lt", "le", "gt", "ge", "eq", "ne")

    config_names = ("op", "value", "const_first")

    def __init__(self, op: str = "lt", value: float = 0.0,
                 const_first: bool = False):
        if op not in self._OPS:
            raise ValueError(f"op must be one of {self._OPS}")
        super().__init__()
        self.op, self.value, self.const_first = op, value, const_first

    def forward(self, x):
        v = torch.as_tensor(self.value, dtype=x.dtype, device=x.device)
        a, b = (v, x) if self.const_first else (x, v)
        return {"lt": torch.lt, "le": torch.le, "gt": torch.gt,
                "ge": torch.ge, "eq": torch.eq, "ne": torch.ne}[self.op](a, b)


class GatherIndices(AbstractModule):
    """TF ``GatherV2`` with constant indices along 1-based ``dim`` (JAX
    :1067): the indices are taken as ``jnp.take`` takes them, 0-based,
    a negative one counting from the end, one outside [−n, n) reading
    NaN."""

    config_names = ("dim", "indices")

    def __init__(self, dim: int = 1, indices=()):
        super().__init__()
        self.dim = dim
        self.indices = [int(i) for i in indices]

    def forward(self, x):
        d = _dim0(self.dim, x.dim())
        n = x.shape[d]
        idx = torch.as_tensor(self.indices, dtype=torch.long,
                              device=x.device)
        valid = (idx >= -n) & (idx < n)
        out = x.index_select(d, torch.where(valid, torch.remainder(idx, n),
                                            0))
        if bool(valid.all()):
            return out
        shape = [1] * x.dim()
        shape[d] = -1
        return torch.where(valid.reshape(shape), out,
                           out.new_tensor(float("nan")))


class Reverse(AbstractModule):
    """Flip along 1-based ``dimension`` (JAX :1083)."""

    config_names = ("dimension",)

    def __init__(self, dimension: int = 1, is_inplace: bool = False):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.flip(x, (self.dimension - 1,))


class CumSum(AbstractModule):
    """Cumulative sum along 1-based ``dimension`` with TF's
    ``exclusive`` and ``reverse`` flags (JAX :1094); exclusive is the
    inclusive sum shifted by one, not y − x."""

    config_names = ("dimension", "exclusive", "reverse")

    def __init__(self, dimension: int = 1, exclusive: bool = False,
                 reverse: bool = False):
        super().__init__()
        self.dimension = dimension
        self.exclusive = exclusive
        self.reverse = reverse

    def forward(self, x):
        d = self.dimension - 1
        v = torch.flip(x, (d,)) if self.reverse else x
        y = torch.cumsum(v, dim=d)
        if self.exclusive:
            head = torch.zeros_like(y.narrow(d, 0, 1))
            y = torch.cat([head, y.narrow(d, 0, y.shape[d] - 1)], dim=d)
        return torch.flip(y, (d,)) if self.reverse else y


class FillLike(AbstractModule):
    """A constant tensor of the input's shape (TF ZerosLike/OnesLike,
    JAX :1127): the input gives its shape only (no gradient)."""

    config_names = ("value",)

    def __init__(self, value: float = 0.0):
        super().__init__()
        self.value = value

    def forward(self, x):
        return torch.full_like(x, self.value)


def _mirror_index(n: int, before: int, after: int, symmetric: bool,
                  device) -> torch.Tensor:
    i = torch.arange(-before, n + after, device=device)
    if symmetric:
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    i = torch.abs(i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


class MirrorPad(AbstractModule):
    """TF REFLECT / SYMMETRIC padding, ``paddings`` a (before, after)
    pair for every dim, batch included (JAX :1142); one index gather a
    padded dim."""

    config_names = ("paddings", "mode")

    def __init__(self, paddings, mode: str = "REFLECT"):
        super().__init__()
        self.paddings = [list(p) for p in paddings]
        self.mode = mode

    def forward(self, x):
        sym = self.mode != "REFLECT"
        for d, (lo, hi) in enumerate(self.paddings):
            if lo or hi:
                x = x.index_select(d, _mirror_index(x.shape[d], lo, hi, sym,
                                                    x.device))
        return x


# --------------------------------------------------------------------------
# Misc
# --------------------------------------------------------------------------


class MaskedSelect(AbstractModule):
    """Table (tensor, mask) -> the 1-D tensor of the elements where the
    mask is not 0 (JAX :1161).  Its size depends on the data: it runs
    eagerly, as in JAX and the reference."""

    def forward(self, x):
        t, mask = x
        return t.reshape(-1)[mask.reshape(-1) != 0]


class PairwiseDistance(AbstractModule):
    """Table (x1, x2) -> the per-row p-norm distance (JAX :1179)."""

    config_names = ("norm",)

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, x):
        x1, x2 = x
        d = torch.abs(x1 - x2) ** self.norm
        return torch.sum(d, dim=-1) ** (1.0 / self.norm)


class Maxout(AbstractModule):
    """``Linear`` to ``maxout_number · output_size``, then the max over
    the maxout groups (JAX :1194).  The weight is JAX's
    ``(input_size, maxout_number · output_size)``, multiplied from the
    right; weight and bias are U(±1/√in)."""

    config_names = ("input_size", "output_size", "maxout_number",
                    "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, input_size: int, output_size: int,
                 maxout_number: int, with_bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.maxout_number = maxout_number
        self.with_bias = with_bias
        self.reset()

    def reset(self):
        """JAX :1214: weight and bias U(±1/√in)."""
        n_out = self.maxout_number * self.output_size
        bound = 1.0 / math.sqrt(self.input_size)
        rng = RandomGenerator.RNG
        self._set_param("weight", rng.uniform(
            -bound, bound, (self.input_size, n_out)).astype(np.float32))
        self._set_param("bias", rng.uniform(-bound, bound, n_out).astype(
            np.float32) if self.with_bias else None)
        return self

    def forward(self, x):
        x, squeezed = _auto_batch(x, 2)
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        y = torch.amax(y.reshape(y.shape[0], self.maxout_number,
                                 self.output_size), dim=1)
        return y[0] if squeezed else y


class Highway(AbstractModule):
    """Keras 1.2.2 ``Highway`` (JAX :1244): ``t·h + (1 − t)·x`` with
    ``h = act(x Wᵀ + b)`` and the carry gate ``t = σ(x W_cᵀ + b_c)``,
    the carry bias starting at −2.  ``activation`` is a module, a layer
    class name or None; the spec keeps its class name."""

    config_names = ("size", "with_bias", "activation")

    param_names = ("weight", "bias", "carry_weight", "carry_bias")

    def __init__(self, size: int, with_bias: bool = True, activation=None):
        super().__init__()
        if isinstance(activation, str):
            from bigdl_tpu_torch.utils.serializer import lookup_module_class

            activation = lookup_module_class(activation)()
        self.size = size
        self.with_bias = with_bias
        self.activation = (type(activation).__name__
                           if activation is not None else None)
        # the activation runs inside this layer: no child, no spec
        object.__setattr__(self, "_act", activation)
        self.reset()

    def reset(self):
        """JAX :1270: both weights U(±1/√size), the carry bias at −2."""
        size = self.size
        bound = 1.0 / math.sqrt(size)
        rng = RandomGenerator.RNG
        w = rng.uniform(-bound, bound, (size, size)).astype(np.float32)
        wc = rng.uniform(-bound, bound, (size, size)).astype(np.float32)
        self._set_param("weight", w)
        self._set_param("carry_weight", wc)
        self._set_param("bias", np.zeros(size, np.float32)
                        if self.with_bias else None)
        self._set_param("carry_bias", np.full(size, -2.0, np.float32)
                        if self.with_bias else None)
        return self

    def forward(self, x):
        h = x @ self.weight.t()
        t = x @ self.carry_weight.t()
        if self.bias is not None:
            h = h + self.bias
            t = t + self.carry_bias
        if self._act is not None:
            h = self._act(h)
        t = torch.sigmoid(t)
        return t * h + (1.0 - t) * x


class SReLU(AbstractModule):
    """S-shaped ReLU with four learnable tensors of ``shape`` (JAX
    :1308): ``t_r + a_r (x − t_r)`` at or above t_r, ``t_l + a_l (x −
    t_l)`` at or below t_l, x between.  Keras 1.2.2's initial values:
    t_left 0, a_left and t_right Glorot-uniform, a_right 1."""

    config_names = ("shape",)

    param_names = ("t_left", "a_left", "t_right", "a_right")

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.reset()

    def reset(self):
        """JAX :1322."""
        if len(self.shape) == 2:
            fan_in, fan_out = float(self.shape[0]), float(self.shape[1])
        else:
            fan_in = fan_out = float(np.sqrt(np.prod(self.shape)))
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        rng = RandomGenerator.RNG
        self._set_param("t_left", np.zeros(self.shape, np.float32))
        self._set_param("a_left", rng.uniform(-limit, limit, self.shape)
                        .astype(np.float32))
        self._set_param("t_right", rng.uniform(-limit, limit, self.shape)
                        .astype(np.float32))
        self._set_param("a_right", np.ones(self.shape, np.float32))
        return self

    def forward(self, x):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), y)


class RoiPooling(AbstractModule):
    """Fast R-CNN region-of-interest max pooling (JAX :1353): table
    (data (B, C, H, W), rois (R, 5)) with rows (1-based image, x1, y1,
    x2, y2) -> (R, C, pooled_h, pooled_w).  The box rounds half to
    even (``jnp.round``, as ``torch.round``); each bin is a masked max
    over its integer rows and columns (``torch.amax``, which splits
    the gradient among tied maxima as JAX's max does); an empty bin
    reads 0."""

    config_names = ("pooled_w", "pooled_h", "spatial_scale")

    def __init__(self, pooled_w: int, pooled_h: int,
                 spatial_scale: float = 1.0):
        super().__init__()
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    @staticmethod
    def _interval_mask(starts, ends, size):
        idx = torch.arange(size, dtype=torch.float32, device=starts.device)
        return (idx[None, None, :] >= starts[:, :, None]) & (
            idx[None, None, :] < ends[:, :, None])

    def forward(self, x):
        data, rois = x[0], x[1]
        _, _, H, W = data.shape
        ph, pw = self.pooled_h, self.pooled_w
        rois = rois.float()
        img = rois[:, 0].to(torch.int32).long() - 1
        s = self.spatial_scale
        x1, y1 = torch.round(rois[:, 1] * s), torch.round(rois[:, 2] * s)
        x2, y2 = torch.round(rois[:, 3] * s), torch.round(rois[:, 4] * s)
        # divided by tensors: CUDA divides by a host scalar as a multiply
        # by its reciprocal, an ulp off, and a bin edge at an integer
        # then moves by a whole cell under floor/ceil
        bin_w = torch.clamp_min(x2 - x1 + 1.0, 1.0) / torch.full_like(x1, pw)
        bin_h = torch.clamp_min(y2 - y1 + 1.0, 1.0) / torch.full_like(y1, ph)
        j = torch.arange(pw, dtype=torch.float32, device=data.device)
        i = torch.arange(ph, dtype=torch.float32, device=data.device)
        wstart = torch.clamp(torch.floor(j[None] * bin_w[:, None])
                             + x1[:, None], 0, W)
        wend = torch.clamp(torch.ceil((j[None] + 1) * bin_w[:, None])
                           + x1[:, None], 0, W)
        hstart = torch.clamp(torch.floor(i[None] * bin_h[:, None])
                             + y1[:, None], 0, H)
        hend = torch.clamp(torch.ceil((i[None] + 1) * bin_h[:, None])
                           + y1[:, None], 0, H)
        mask_w = self._interval_mask(wstart, wend, W)      # (R, pw, W)
        mask_h = self._interval_mask(hstart, hend, H)      # (R, ph, H)
        v = data[img]                                      # (R, C, H, W)
        neg = torch.full((), float("-inf"), dtype=v.dtype, device=v.device)
        t = torch.amax(torch.where(mask_w[:, None, None, :, :],
                                   v[:, :, :, None, :], neg), dim=-1)
        y = torch.amax(torch.where(mask_h[:, None, :, :, None],
                                   t[:, :, None, :, :], neg), dim=3)
        return torch.where(torch.isneginf(y), torch.zeros_like(y), y)


class NegativeEntropyPenalty(AbstractModule):
    """The identity forward; ``penalty(p)`` is β·Σ p·log p (JAX
    :1420).  As in JAX, the penalty is not collected into the loss
    (``regularization_loss`` is 0)."""

    config_names = ("beta",)

    def __init__(self, beta: float = 0.01):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return x

    def regularization_loss(self, params=None):
        return 0.0

    def penalty(self, p):
        return self.beta * torch.sum(p * torch.log(torch.clamp_min(p,
                                                                    1e-12)))


__all__ = [
    "LocallyConnected1D", "LocallyConnected2D",
    "SpatialSeparableConvolution", "SpatialShareConvolution",
    "SpatialConvolutionMap", "TemporalMaxPooling", "SoftShrink",
    "HardShrink", "TanhShrink", "LogSigmoid", "RReLU", "GaussianDropout",
    "GaussianNoise", "GaussianSampler", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D", "Cropping2D", "UpSampling1D",
    "UpSampling2D", "ResizeBilinear", "ResizeNearestNeighbor",
    "DepthToSpace", "SpaceToDepth", "SpatialWithinChannelLRN",
    "SpatialSubtractiveNormalization", "SpatialDivisiveNormalization",
    "SpatialContrastiveNormalization", "ExpandSize", "InferReshape", "Tile",
    "SplitChunks", "TemporalAveragePooling", "GatherIndices",
    "CompareConstant", "Reverse", "CumSum", "FillLike", "MirrorPad",
    "MaskedSelect", "Maxout", "Highway", "SReLU", "RoiPooling",
    "PairwiseDistance", "NegativeEntropyPenalty",
]
