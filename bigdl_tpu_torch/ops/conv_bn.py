"""Fused convolution + BatchNorm statistics (1x1 and kxk).

Counterpart of ``bigdl_tpu/ops/conv_bn.py``.  ``conv_bn_stats(x, w,
shift)`` returns the convolution ``y`` and the per-channel sums
``s1 = Σ(y − shift)`` and ``s2 = Σ(y − shift)²`` over N·Ho·Wo, taken
from the f32 accumulator before ``y`` is rounded to x's dtype.  The
BN layer that follows (``nn/fused.py``) then never reads ``y`` again
for its statistics.

* ``conv_bn_stats_plain`` ports ``_reference`` (JAX :101-115): the
  conv in f32, then the two sums.  A CPU tensor takes it, and
  ``chip_smoke.py`` holds the kernels to it on the card.
* On a CUDA tensor the wrapper launches a hand-written kernel, or
  raises (:func:`kernel_path` names which): ``csrc/conv_bn_1x1.cu``
  (JAX ``_fwd_kernel_1x1``, :127) for a 1x1 conv without padding, a
  strided site read in place (JAX subsamples first, :451-454), and
  ``csrc/conv_bn_kxk.cu`` (JAX ``_fwd_kernel_kxk``, :238) for every
  other shape, stride 1 and 2 directly.  In bf16 both are GEMMs on the
  tensor cores with the output pixels flattened across samples: the 1x1
  reads NCHW x as it lies (C a multiple of 8; a bf16 1x1 with other C
  goes to the kxk kernel), the kxk an implicit GEMM over the layout
  that :func:`kxk_operands` states (x as NHWC, w as (O, k, k, C),
  tap-major as JAX's im2col, C zero-padded to a multiple of 8), which
  its own transpose pass writes into scratch the wrapper allocates; in
  f32 both run on the CUDA cores over NCHW x.
* ``impl="xla"`` is the auto-tuner's other arm (JAX ``impl="xla"``,
  ``_reference`` :101-115): ``F.conv2d`` on f32 copies of x and w (a
  bf16 conv with an f32 output, as ``preferred_element_type=f32``),
  then the two sums.  ``impl="auto"`` takes the kernel, or with
  ``BIGDL_TORCH_TUNER=1`` the cached per-shape decision
  (``ops/autotune.decide_conv_bn``).
* The backward is ``_bwd_rule`` (JAX :465-490): with cotangents
  (gy, gs1, gs2), ``gy_eff = gy + gs1 + 2(y − shift)·gs2`` in f32 cast
  to x's dtype, then the gradients of the plain strided conv at
  ``gy_eff`` (cuDNN on the card, as XLA's conv grads are in JAX), and
  ``gshift = −n·gs1 − 2·s1·gs2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _cuda


def _acc(dtype):
    """The accumulation dtype: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _conv_then_sums(x, w, shift, stride: int, pad: int):
    acc = _acc(x.dtype)
    y = F.conv2d(x.to(acc), w.to(acc), stride=stride, padding=pad)
    yc = y - shift.to(acc)[None, :, None, None]
    return y.to(x.dtype), yc.sum(dim=(0, 2, 3)), (yc * yc).sum(dim=(0, 2, 3))


def conv_bn_stats_plain(x, w, shift, stride: int = 1, pad: int = 0):
    """x (N, C, H, W), w (O, C, k, k), shift (O,) f32 -> (y in x's
    dtype, s1, s2 f32): the conv with f32 accumulation, then the sums
    of the centred f32 output.  The kernels' plain version."""
    return _conv_then_sums(x, w, shift, stride, pad)


def conv_bn_stats_xla(x, w, shift, stride: int = 1, pad: int = 0):
    """The ``impl="xla"`` arm, on either device: the library conv with
    f32 accumulation, then the sums (JAX ``_reference``).  The same
    arithmetic as :func:`conv_bn_stats_plain`, kept apart because it
    is a dispatch choice on the card, not the kernels' yardstick."""
    return _conv_then_sums(x, w, shift, stride, pad)


def _check_cuda_args(x, w, shift):
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != w.shape[3]:
        raise ValueError(f"conv_bn kernels want x (N,C,H,W) and square w "
                         f"(O,C,k,k); got {tuple(x.shape)}, {tuple(w.shape)}")
    if w.shape[1] != x.shape[1] or shift.shape != (w.shape[0],):
        raise ValueError(f"conv_bn shapes disagree: x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} shift {tuple(shift.shape)}")
    if not (x.device == w.device == shift.device):
        raise ValueError("conv_bn: x, w and shift on different devices")
    if x.dtype not in _cuda.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"conv_bn kernels take f32 or bf16 x and w of one "
                         f"dtype, got {x.dtype} and {w.dtype}")


def kxk_operands(x, w):
    """The operands of the bf16 kxk GEMM, in plain PyTorch: x (N, C, H, W)
    as NHWC (N, H, W, Cp) and w (O, C, k, k) as (O, k, k, Cp), with C
    zero-padded to Cp, the next multiple of 8.  Each pixel's channels at
    one tap and each output channel's weights are then contiguous in
    JAX's tap-major K order (``_fwd_kxk``'s ``(dy, dx, c)``, :404) and
    start on a 16-byte boundary, as the kernel's 16-byte copies need;
    the padded channels are zero in both, so they add nothing to the
    sums.  The kernel's own layout pass (``to_nhwc_kernel``) writes the
    same into its scratch; the CPU tests model the GEMM on this."""
    pad_c = -x.shape[1] % 8
    xh, wt = x.permute(0, 2, 3, 1), w.permute(0, 2, 3, 1)
    if pad_c:
        xh, wt = F.pad(xh, (0, pad_c)), F.pad(wt, (0, pad_c))
    return xh.contiguous(), wt.contiguous()


def _conv_bn_cuda(x, w, shift, stride: int, pad: int):
    """Launch the kernel for this shape: (y, s1, s2)."""
    _check_cuda_args(x, w, shift)
    one = kernel_path(x.shape, w.shape, stride=stride, pad=pad,
                      itemsize=x.element_size()) == "cuda_1x1"
    x, w = x.contiguous(), w.contiguous()
    shift = shift.float().contiguous()
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"conv_bn: empty output for x {tuple(x.shape)}, "
                         f"k={k}, stride={stride}, pad={pad}")
    y = torch.empty((n, o, ho, wo), dtype=x.dtype, device=x.device)
    mma = x.dtype == torch.bfloat16          # the tensor-core kernels
    cols = (_cuda.conv_mma_tiles(n * ho * wo) if mma
            else n * _cuda.conv_bn_tiles(ho * wo))
    part = torch.empty((2, o, cols), dtype=torch.float32, device=x.device)
    s1, s2 = (torch.empty(o, dtype=torch.float32, device=x.device)
              for _ in range(2))
    if one:
        if mma and w.data_ptr() % 16:        # its 16-byte weight copies
            w = w.clone()
        _cuda.launch_conv_bn_1x1(x, w, shift, y, part, s1, s2,
                                 stride=stride)
    else:
        scratch = None
        if mma:         # the kernel's NHWC operands, channels padded to 8
            cp = -(-c // 8) * 8
            scratch = (x.new_empty((n, h, wd, cp)),
                       w.new_empty((o, k, k, cp)))
        _cuda.launch_conv_bn_kxk(x, w, shift, y, part, s1, s2,
                                 stride=stride, pad=pad, scratch=scratch)
    return y, s1, s2


def _forward(x, w, shift, stride: int, pad: int, impl: str = "kernel"):
    if impl == "xla":
        return conv_bn_stats_xla(x, w, shift, stride, pad)
    if x.device.type == "cpu":
        return conv_bn_stats_plain(x, w, shift, stride, pad)
    if x.device.type == "cuda":
        return _conv_bn_cuda(x, w, shift, stride, pad)
    raise ValueError(f"conv_bn_stats: unsupported device {x.device}")


class _ConvBNStats(torch.autograd.Function):
    """The custom VJP of JAX ``_conv_bn_stats_vjp`` (:444-493)."""

    @staticmethod
    def forward(ctx, x, w, shift, stride, pad, impl):
        y, s1, s2 = _forward(x, w, shift, stride, pad, impl)
        ctx.save_for_backward(x, w, y, shift, s1)
        ctx.stride, ctx.pad = stride, pad
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y, shift, s1 = ctx.saved_tensors
        stride, pad = ctx.stride, ctx.pad
        c = (None, slice(None), None, None)
        acc = _acc(x.dtype)
        yc = y.to(acc) - shift.to(acc)[c]
        gy_eff = (gy.to(acc) + gs1[c] + 2.0 * yc * gs2[c]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, gy_eff, stride, pad)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gy_eff, stride, pad)
        n = y.shape[0] * y.shape[2] * y.shape[3]
        gshift = (-float(n) * gs1 - 2.0 * s1 * gs2).to(shift.dtype)
        return dx, dw, gshift, None, None, None


def conv_bn_stats(x, w, shift, *, stride: int = 1, pad: int = 0,
                  impl: str = "auto"):
    """Fused conv + centred BN statistics (JAX ``conv_bn_stats``).

    x (N, C, H, W); w (O, C, k, k) or (O, C) for 1x1; shift (O,) f32,
    typically the BN running mean.  Returns (y, s1, s2): y in x's
    dtype, s1/s2 (O,) f32.  Differentiable in x, w and shift.

    ``impl``: "kernel" (a CUDA tensor launches ``conv_bn_1x1`` or
    ``conv_bn_kxk``, f32 or bf16, any odd or even k, stride and pad, or
    raises; a CPU tensor runs :func:`conv_bn_stats_plain`), "xla"
    (:func:`conv_bn_stats_xla`), or "auto" ("kernel", or the cached
    auto-tuner decision when ``BIGDL_TORCH_TUNER=1``)."""
    if w.dim() == 2:
        w = w[:, :, None, None]
    if impl == "auto":
        impl = "kernel"
        from bigdl_tpu_torch.ops import autotune

        if autotune.enabled():
            decision = autotune.decide_conv_bn(
                x.shape, w.shape, x.dtype, stride=int(stride), pad=int(pad),
                arrays=(x, w, shift))
            if decision is not None:
                impl = decision["impl"]
    if impl not in ("kernel", "xla"):
        raise ValueError(f"impl must be auto|kernel|xla, got {impl!r}")
    return _ConvBNStats.apply(x, w, shift.to(_acc(x.dtype)), int(stride),
                              int(pad), impl)


def conv1x1_bn_stats(x, w, shift, *, stride: int = 1):
    """The 1x1 form with w (O, C)."""
    return conv_bn_stats(x, w, shift, stride=stride, pad=0)


def kernel_path(x_shape, w_shape, *, stride: int = 1, pad: int = 0,
                itemsize: int = 2) -> str:
    """Which kernel ``conv_bn_stats`` launches on the card for these
    shapes and the dtype's ``itemsize``: ``"cuda_1x1"`` for a 1x1 conv
    without padding, any stride (in bf16 only where C is a multiple of 8,
    the 16-byte rows of its weight copies), else ``"cuda_kxk"`` (a bf16
    1x1 with other C too: its layout pass pads C).  Every shape has one
    (no fallback)."""
    w_shape = tuple(int(s) for s in w_shape)
    k = 1 if len(w_shape) == 2 else w_shape[2]
    if k == 1 and pad == 0 and (itemsize != 2 or int(x_shape[1]) % 8 == 0):
        return "cuda_1x1"
    return "cuda_kxk"


__all__ = ["conv_bn_stats", "conv_bn_stats_plain", "conv_bn_stats_xla",
           "conv1x1_bn_stats",
           "kernel_path", "kxk_operands"]
