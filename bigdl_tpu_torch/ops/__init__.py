"""Attention ops of the PyTorch/CUDA port and their CUDA kernels
(counterpart of ``bigdl_tpu.ops``)."""

from bigdl_tpu_torch.ops.attention import (dot_product_attention,
                                           flash_attention)
from bigdl_tpu_torch.ops.decode_attention import paged_decode_attention

__all__ = ["dot_product_attention", "flash_attention",
           "paged_decode_attention"]
