"""Ops of the PyTorch/CUDA port and their CUDA kernels (counterpart of
``bigdl_tpu.ops``): attention, paged decode, and the fused conv + BN
statistics, with the kernel auto-tuner that picks between each site's
impls (``ops.autotune``)."""

from bigdl_tpu_torch.ops import autotune  # noqa: F401
from bigdl_tpu_torch.ops.attention import (dot_product_attention,
                                           flash_attention)
from bigdl_tpu_torch.ops.conv_bn import (conv1x1_bn_stats, conv_bn_stats,
                                         kernel_path)
from bigdl_tpu_torch.ops.decode_attention import paged_decode_attention
from bigdl_tpu_torch.ops.quantized_matmul import (int8_matmul,
                                                  quantize_per_channel)

__all__ = ["autotune", "dot_product_attention", "flash_attention",
           "paged_decode_attention", "conv_bn_stats", "conv1x1_bn_stats",
           "kernel_path", "int8_matmul", "quantize_per_channel"]
