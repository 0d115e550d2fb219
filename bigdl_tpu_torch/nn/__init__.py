"""Layers of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.module import AbstractModule, Composite
from bigdl_tpu_torch.nn.layers import InitializationMethod, Linear, Xavier
from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEmbedding,
                                          TransformerBlock)

__all__ = ["AbstractModule", "Composite", "InitializationMethod", "Linear",
           "Xavier", "LayerNorm", "MultiHeadAttention",
           "PositionalEmbedding", "TransformerBlock"]
