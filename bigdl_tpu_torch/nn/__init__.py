"""Layers of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.module import (AbstractModule, Composite, Container,
                                       Identity, Sequential)
from bigdl_tpu_torch.nn.layers import (BatchNormalization,
                                       InitializationMethod, Linear,
                                       LogSoftMax, LookupTable, MsraFiller,
                                       ReLU, Reshape, Sigmoid,
                                       SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, SpatialMaxPooling,
                                       Tanh, View, Xavier, Zeros)
from bigdl_tpu_torch.nn.table_ops import CAddTable, ConcatTable
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fused import SpatialConvolutionBatchNorm, fuse_conv_bn
from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEmbedding,
                                          TransformerBlock)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          LSTMPeephole, MultiRNNCell,
                                          Recurrent, RnnCell, Select,
                                          TimeDistributed)

__all__ = ["AbstractModule", "Composite", "Container", "Identity",
           "Sequential", "BatchNormalization", "InitializationMethod",
           "Linear", "LogSoftMax", "MsraFiller", "ReLU", "Reshape",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "View", "Xavier",
           "Zeros", "CAddTable", "ConcatTable", "ClassNLLCriterion",
           "CrossEntropyCriterion", "SpatialConvolutionBatchNorm",
           "fuse_conv_bn", "LayerNorm", "MultiHeadAttention",
           "PositionalEmbedding", "TransformerBlock", "LookupTable", "Tanh",
           "Sigmoid", "TimeDistributedCriterion", "Cell", "RnnCell", "LSTM",
           "LSTMPeephole", "GRU", "Recurrent", "BiRecurrent",
           "TimeDistributed", "Select", "MultiRNNCell"]
