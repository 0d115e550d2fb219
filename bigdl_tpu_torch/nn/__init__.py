"""Layers of the PyTorch/CUDA port (counterpart of ``bigdl_tpu.nn``)."""

from bigdl_tpu_torch.nn.module import (AbstractModule, Composite, Container,
                                       Identity, Sequential)
from bigdl_tpu_torch.nn.layers import (ELU, Abs, BatchNormalization,
                                       Dropout, Exp, InitializationMethod,
                                       LeakyReLU, Linear, Log, LogSoftMax,
                                       LookupTable, MsraFiller, Power, PReLU,
                                       ReLU, Reshape, Scale, Sigmoid,
                                       SoftMax, SoftPlus,
                                       SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution,
                                       SpatialCrossMapLRN,
                                       SpatialDilatedConvolution,
                                       SpatialFullConvolution,
                                       SpatialMaxPooling, Tanh, View, Xavier,
                                       Zeros)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CMaxTable, CMulTable,
                                          Concat, ConcatTable, JoinTable)
from bigdl_tpu_torch.nn.graph import (DynamicGraph, Graph, Input, Model,
                                      Node)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion, MSECriterion,
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
           "CrossEntropyCriterion", "MSECriterion",
           "SpatialConvolutionBatchNorm",
           "fuse_conv_bn", "LayerNorm", "MultiHeadAttention",
           "PositionalEmbedding", "TransformerBlock", "LookupTable", "Tanh",
           "Sigmoid", "TimeDistributedCriterion", "Cell", "RnnCell", "LSTM",
           "LSTMPeephole", "GRU", "Recurrent", "BiRecurrent",
           "TimeDistributed", "Select", "MultiRNNCell", "Dropout", "SoftMax",
           "SoftPlus", "ELU", "LeakyReLU", "PReLU", "Abs", "Power", "Log",
           "Exp", "Scale", "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialFullConvolution", "CMulTable", "CMaxTable", "JoinTable",
           "Concat", "Node", "Input", "Graph", "DynamicGraph", "Model"]
