"""bigdl_tpu_torch.keras: the Keras-1.2.2-compatible API of the port.

Counterpart of ``bigdl_tpu/keras``: a ``Sequential`` model with
``input_shape`` on its first layer, shape inference layer to layer, the
Keras training verbs (compile/fit/evaluate/predict) over the port's
trainers, and the JSON and HDF5 importer (``keras.converter``).  Models
are built on ``device=``, the card unless the caller asks for the CPU.
"""

from bigdl_tpu_torch.keras.layers import (
    Activation,
    AveragePooling2D,
    BatchNormalization,
    Bidirectional,
    Convolution2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GlobalAveragePooling2D,
    GlobalMaxPooling2D,
    GRU,
    InputLayer,
    KerasLayer,
    LSTM,
    MaxPooling2D,
    Permute,
    RepeatVector,
    Reshape,
    SimpleRNN,
    TimeDistributedDense,
    ZeroPadding2D,
)
from bigdl_tpu_torch.keras.models import Model, Sequential

__all__ = [
    "Model",
    "Sequential", "KerasLayer", "InputLayer", "Dense", "Activation",
    "Dropout", "Flatten", "Reshape", "Permute", "RepeatVector",
    "Convolution2D", "MaxPooling2D", "AveragePooling2D", "ZeroPadding2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "BatchNormalization",
    "Embedding", "LSTM", "GRU", "SimpleRNN", "Bidirectional",
    "TimeDistributedDense",
]
