"""Quantized inference: ``quantize(module)`` and ``Quantizer``.

Counterpart of ``bigdl_tpu/nn/quantized.py``.  Weights are quantized
symmetrically per output channel when a layer is swapped; activations
are quantized on the fly, per row in ``QuantizedLinear`` and per tensor
in ``QuantizedSpatialConvolution``, and every product accumulates in
int32 (``ops/quantized_matmul.py``: ``torch._int_mm``).  The JAX conv
runs an int8 ``conv_general_dilated``; plain torch has no int8 conv on
CUDA, so here the conv is an im2col (a strided view for 1x1, ``unfold``
of the codes as float32, exact for integers up to 127, otherwise)
followed by the int8 GEMM: the same int32 sums, so the same outputs.
Quantized layers are inference-only, as in the reference: ``backward``
raises.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import AbstractModule, Container
from bigdl_tpu_torch.ops.quantized_matmul import (int8_matmul, int8_mm,
                                                  quantize_per_channel)


class _QuantizedBase(AbstractModule):
    """Holds the int8 weight, its per-channel scale and the float bias
    as buffers, listed as the JAX package's params."""

    param_names = ("weight_q", "weight_scale", "bias")

    def _set_quantized(self, weight, bias):
        w = weight.detach()
        q, scale = quantize_per_channel(w, axis=0)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.register_buffer("bias", None if bias is None
                             else bias.detach().clone())

    def backward(self, input, grad_output):
        raise RuntimeError(
            "quantized modules are inference-only (reference: "
            "nn/quantized layers throw on backward)")


class QuantizedLinear(_QuantizedBase):
    """int8 ``y = x @ Wq.T * s + b`` (JAX :42)."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self._set_quantized(torch.as_tensor(weight), None if bias is None
                            else torch.as_tensor(bias))
        self.out_features, self.in_features = (int(s) for s in
                                               self.weight_q.shape)

    def forward(self, x):
        y = int8_matmul(x, self.weight_q, self.weight_scale,
                        device=x.device)
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self):
        return f"{self.in_features} -> {self.out_features}"


class QuantizedSpatialConvolution(_QuantizedBase):
    """int8 NCHW conv (JAX :67-111): per-tensor activation codes,
    per-channel weight codes, an int32 accumulator, then
    ``acc * x_scale * w_scale`` (+ bias).  ``padding`` is the JAX
    package's ((top, bottom), (left, right))."""

    def __init__(self, weight, bias, stride, padding, n_group: int = 1,
                 dilation=(1, 1)):
        super().__init__()
        self._set_quantized(torch.as_tensor(weight), None if bias is None
                            else torch.as_tensor(bias))
        self.stride = tuple(int(s) for s in stride)
        self.padding = [tuple(int(p) for p in pair) for pair in padding]
        self.n_group = int(n_group)
        self.dilation = tuple(int(d) for d in dilation)

    def _columns(self, x_q):
        """(N·Ho·Wo, C·kh·kw) int8 rows of the conv's patches, and
        (Ho, Wo)."""
        (pt, pb), (pl, pr) = self.padding
        kh, kw = self.weight_q.shape[2:]
        sh, sw = self.stride
        if (kh, kw) == (1, 1) and not any((pt, pb, pl, pr)):
            x_q = x_q[:, :, ::sh, ::sw]
            ho, wo = x_q.shape[2:]
            return x_q.permute(0, 2, 3, 1).reshape(-1, x_q.shape[1]), \
                (ho, wo)
        xf = F.pad(x_q.to(torch.float32), (pl, pr, pt, pb))
        dh, dw = self.dilation
        ho = (xf.shape[2] - dh * (kh - 1) - 1) // sh + 1
        wo = (xf.shape[3] - dw * (kw - 1) - 1) // sw + 1
        cols = F.unfold(xf, (kh, kw), dilation=self.dilation,
                        stride=self.stride)          # (N, C·kh·kw, L)
        return cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(
            torch.int8), (ho, wo)

    def forward(self, x):
        absmax = torch.amax(torch.abs(x))
        x_scale = torch.clamp_min(absmax, 1e-8) / 127.0
        x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(
            torch.int8)
        n, c = x.shape[:2]
        o = self.weight_q.shape[0]
        g = self.n_group
        accs = []
        for i in range(g):
            xg = x_q[:, i * c // g:(i + 1) * c // g]
            wg = self.weight_q[i * o // g:(i + 1) * o // g]
            cols, (ho, wo) = self._columns(xg)
            accs.append(int8_mm(cols, wg.reshape(wg.shape[0], -1)))
        acc = torch.cat(accs, dim=1) if g > 1 else accs[0]
        acc = acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)
        y = acc.float() * x_scale * self.weight_scale.reshape(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y


def quantize(module: AbstractModule) -> AbstractModule:
    """A copy of the module tree with every ``Linear`` and
    ``SpatialConvolution`` swapped for its int8 twin (JAX :114); the
    input module is left as it is."""
    return _quantize_inplace(copy.deepcopy(module))


def _quantize_inplace(module: AbstractModule) -> AbstractModule:
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.nn.fused import SpatialConvolutionBatchNorm
    from bigdl_tpu_torch.nn.module import Sequential

    if isinstance(module, L.Linear):
        q = QuantizedLinear(module.weight, module.bias)
        return q.set_name(module._name) if module._name else q
    if type(module) in (L.SpatialConvolution, L.SpatialDilatedConvolution):
        # the port's convs take symmetric, non-negative pads only
        pads = [(module.pad_h, module.pad_h), (module.pad_w, module.pad_w)]
        dilation = (getattr(module, "dilation_h", 1),
                    getattr(module, "dilation_w", 1))
        q = QuantizedSpatialConvolution(
            module.weight, module.bias, (module.stride_h, module.stride_w),
            pads, module.n_group, dilation)
        return q.set_name(module._name) if module._name else q
    if isinstance(module, SpatialConvolutionBatchNorm):
        # eval-mode BN folds into the conv (JAX :157-164):
        # w' = w * scale_c, b' = offset_c from the running statistics
        with torch.no_grad():
            inv = torch.rsqrt(module.running_var + module.eps)
            scale = inv * module.bn_weight
            offset = module.bn_bias - module.running_mean * scale
            w = module.weight
            if w.ndim == 2:
                w = w[:, :, None, None]
            w_folded = w * scale[:, None, None, None].to(w.dtype)
        pads = [(module.pad, module.pad), (module.pad, module.pad)]
        q = QuantizedSpatialConvolution(
            w_folded, offset, (module.stride, module.stride), pads)
        if module.with_relu:
            seq = Sequential().add(q).add(L.ReLU())
            return seq.set_name(module._name) if module._name else seq
        return q.set_name(module._name) if module._name else q
    if isinstance(module, Container):
        topo = getattr(module, "_topo", None)
        if topo is not None:
            # a graph keeps its wiring: each node's module is swapped
            for node in topo:
                node.module = _quantize_inplace(node.module)
            module.modules = [n.module for n in topo]
        else:
            module.modules = [_quantize_inplace(m) for m in module.modules]
        return module
    return module


class Quantizer:
    """Reference spelling: ``Quantizer.quantize(model)``."""

    @staticmethod
    def quantize(module):
        return quantize(module)


__all__ = ["QuantizedLinear", "QuantizedSpatialConvolution", "Quantizer",
           "quantize"]
