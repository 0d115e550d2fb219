"""The volumetric (3-D) layers of the port.

Counterpart of ``bigdl_tpu/nn/volumetric.py`` (7 classes).  Input is
NCDHW; the reference's width-first argument order (kT, kW, kH, dT, dW,
dH, padT, padW, padH) and the JAX weight layouts are kept: OIDHW for
``VolumetricConvolution`` and IODHW (``F.conv_transpose3d``'s own) for
``VolumetricFullConvolution``.  The convs are ``F.conv3d`` and
``F.conv_transpose3d`` (cuDNN on the card), the pools ``F.max_pool3d``
and ``F.avg_pool3d`` over an input padded by JAX's ``_pool_pad`` rule.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import (BatchNormalization,
                                       InitializationMethod, MsraFiller,
                                       _auto_batch, _pool_pad)
from bigdl_tpu_torch.nn.module import AbstractModule


def _same_pads3(shape, kernel, stride):
    """XLA's SAME padding of three spatial dims, F.pad order (last dim
    first), the odd cell at the high end."""
    pads = []
    for n, k, s in zip(reversed(shape), reversed(kernel), reversed(stride)):
        _, (lo, hi) = _pool_pad(n, k, s, -1, False)
        pads += [lo, hi]
    return pads


class VolumetricConvolution(AbstractModule):
    """3-D conv over NCDHW (JAX :49); a -1 pad is SAME on all three
    dims."""

    config_names = ("n_input_plane", "n_output_plane", "k_t", "k_w", "k_h",
                    "d_t", "d_w", "d_h", "pad_t", "pad_w", "pad_h",
                    "with_bias")

    param_names = ("weight", "bias")

    def __init__(self, n_input_plane: int, n_output_plane: int, k_t: int,
                 k_w: int, k_h: int, d_t: int = 1, d_w: int = 1,
                 d_h: int = 1, pad_t: int = 0, pad_w: int = 0,
                 pad_h: int = 0, with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t, self.d_w, self.d_h = d_t, d_w, d_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.with_bias = with_bias
        self._init_method = init_method or MsraFiller(False)
        self.reset()

    def reset(self):
        """JAX :92 and, through ``_weight_shape``, :170."""
        self._set_param("weight", self._init_method.init(
            self._weight_shape(), self.n_input_plane * self._k_vol(),
            self.n_output_plane * self._k_vol()))
        self._set_param("bias", np.zeros(self.n_output_plane, np.float32)
                        if self.with_bias else None)
        return self

    def _k_vol(self):
        return self.k_t * self.k_h * self.k_w

    def _weight_shape(self):
        return (self.n_output_plane, self.n_input_plane, self.k_t, self.k_h,
                self.k_w)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        stride = (self.d_t, self.d_h, self.d_w)
        if -1 in (self.pad_t, self.pad_h, self.pad_w):
            xp = F.pad(x, _same_pads3(x.shape[2:], (self.k_t, self.k_h,
                                                   self.k_w), stride))
            y = F.conv3d(xp, w, b, stride)
        else:
            y = F.conv3d(x, w, b, stride, (self.pad_t, self.pad_h,
                                           self.pad_w))
        return y[0] if squeezed else y


class VolumetricFullConvolution(VolumetricConvolution):
    """Transposed 3-D conv with the reference's ``adj`` output padding
    (JAX :139): out = (in − 1)·stride − 2·pad + kernel + adj.  The
    weight is JAX's (in, out, kT, kH, kW).  torch's output padding must
    stay below the stride and JAX's adj need not, so the whole
    transposed conv is taken, zero-extended by what adj reaches past
    it, and ``pad`` cropped off the front (as
    ``SpatialFullConvolution``)."""

    config_names = VolumetricConvolution.config_names + ("adj_t", "adj_w",
                                                         "adj_h")

    def __init__(self, n_input_plane: int, n_output_plane: int, k_t: int,
                 k_w: int, k_h: int, d_t: int = 1, d_w: int = 1,
                 d_h: int = 1, pad_t: int = 0, pad_w: int = 0,
                 pad_h: int = 0, adj_t: int = 0, adj_w: int = 0,
                 adj_h: int = 0, with_bias: bool = True,
                 init_method: Optional[InitializationMethod] = None):
        super().__init__(n_input_plane, n_output_plane, k_t, k_w, k_h, d_t,
                         d_w, d_h, pad_t, pad_w, pad_h, with_bias,
                         init_method)
        self.adj_t, self.adj_w, self.adj_h = adj_t, adj_w, adj_h

    def _weight_shape(self):
        return (self.n_input_plane, self.n_output_plane, self.k_t, self.k_h,
                self.k_w)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        stride = (self.d_t, self.d_h, self.d_w)
        pad = (self.pad_t, self.pad_h, self.pad_w)
        adj = (self.adj_t, self.adj_h, self.adj_w)
        k = (self.k_t, self.k_h, self.k_w)
        full = F.conv_transpose3d(x, self.weight.to(x.dtype), None, stride)
        out = [(x.shape[2 + i] - 1) * stride[i] - 2 * pad[i] + k[i] + adj[i]
               for i in range(3)]
        full = F.pad(full, (0, max(0, adj[2] - pad[2]),
                            0, max(0, adj[1] - pad[1]),
                            0, max(0, adj[0] - pad[0])))
        y = full[:, :, pad[0]:pad[0] + out[0], pad[1]:pad[1] + out[1],
                 pad[2]:pad[2] + out[2]]
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
        return y[0] if squeezed else y


class _VolumetricPool(AbstractModule):
    def __init__(self, k_t, k_w=None, k_h=None, d_t=None, d_w=None,
                 d_h=None, pad_t=0, pad_w=0, pad_h=0, ceil_mode=False):
        super().__init__()
        self.k_t = k_t
        self.k_w = k_w if k_w is not None else k_t
        self.k_h = k_h if k_h is not None else k_t
        self.d_t = d_t if d_t is not None else self.k_t
        self.d_w = d_w if d_w is not None else self.k_w
        self.d_h = d_h if d_h is not None else self.k_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.ceil_mode = ceil_mode

    def ceil(self):
        """Round the output size up; returns self."""
        self.ceil_mode = True
        return self

    def _pad(self, x, value):
        """x padded by JAX's window padding (``_pool_pad`` a dim), so a
        floor-mode pool over it gives JAX's output size."""
        pads = []
        for n, k, s, p in ((x.shape[4], self.k_w, self.d_w, self.pad_w),
                           (x.shape[3], self.k_h, self.d_h, self.pad_h),
                           (x.shape[2], self.k_t, self.d_t, self.pad_t)):
            _, (lo, hi) = _pool_pad(n, k, s, p, self.ceil_mode)
            pads += [lo, hi]
        return F.pad(x, pads, value=value) if any(pads) else x

    def _window(self):
        return ((self.k_t, self.k_h, self.k_w),
                (self.d_t, self.d_h, self.d_w))


class VolumetricMaxPooling(_VolumetricPool):
    """NCDHW max pooling with the reference's floor/ceil output size,
    padded with −inf (JAX :220)."""

    config_names = ("k_t", "k_w", "k_h", "d_t", "d_w", "d_h", "pad_t",
                    "pad_w", "pad_h", "ceil_mode")

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        y = F.max_pool3d(self._pad(x, float("-inf")), *self._window())
        return y[0] if squeezed else y


class VolumetricAveragePooling(_VolumetricPool):
    """NCDHW average pooling (JAX :268): the window's sum over the
    kernel volume, or with ``count_include_pad=False`` over the cells
    inside the input."""

    config_names = ("k_t", "k_w", "k_h", "d_t", "d_w", "d_h", "pad_t",
                    "pad_w", "pad_h", "count_include_pad", "ceil_mode")

    def __init__(self, k_t, k_w=None, k_h=None, d_t=None, d_w=None,
                 d_h=None, pad_t=0, pad_w=0, pad_h=0,
                 count_include_pad=True, ceil_mode=False):
        super().__init__(k_t, k_w, k_h, d_t, d_w, d_h, pad_t, pad_w, pad_h,
                         ceil_mode)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        kernel, stride = self._window()
        y = F.avg_pool3d(self._pad(x, 0.0), kernel, stride)
        if not self.count_include_pad:
            ones = torch.ones_like(x[:1, :1])
            y = y / F.avg_pool3d(self._pad(ones, 0.0), kernel, stride)
        return y[0] if squeezed else y


class VolumetricBatchNormalization(BatchNormalization):
    """Batch normalization over NCDHW, statistics per channel (JAX
    :322)."""

    _feature_ndim = 5

    def _axes_and_shape(self, x):
        if x.dim() != 5:
            raise ValueError(
                f"VolumetricBatchNormalization expects 5-d input, got "
                f"{x.dim()}-d")
        return (0, 2, 3, 4), (1, self.n_output, 1, 1, 1)


class UpSampling3D(AbstractModule):
    """Nearest repeat of NCDHW's three spatial dims by ``size`` (JAX
    :337)."""

    config_names = ("size",)

    def __init__(self, size=(2, 2, 2)):
        super().__init__()
        self.size = tuple(size)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        for d, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=d)
        return x[0] if squeezed else x


class Cropping3D(AbstractModule):
    """Crop (lo, hi) cells from each spatial dim of NCDHW (JAX :357)."""

    config_names = ("dim1_crop", "dim2_crop", "dim3_crop")

    def __init__(self, dim1_crop=(1, 1), dim2_crop=(1, 1),
                 dim3_crop=(1, 1)):
        super().__init__()
        self.dim1_crop = tuple(dim1_crop)
        self.dim2_crop = tuple(dim2_crop)
        self.dim3_crop = tuple(dim3_crop)

    def forward(self, x):
        x, squeezed = _auto_batch(x, 5)
        (t0, t1), (h0, h1), (w0, w1) = (self.dim1_crop, self.dim2_crop,
                                        self.dim3_crop)
        y = x[:, :, t0:x.shape[2] - t1, h0:x.shape[3] - h1,
              w0:x.shape[4] - w1]
        return y[0] if squeezed else y


__all__ = [
    "VolumetricConvolution", "VolumetricFullConvolution",
    "VolumetricMaxPooling", "VolumetricAveragePooling",
    "VolumetricBatchNormalization", "UpSampling3D", "Cropping3D",
]
