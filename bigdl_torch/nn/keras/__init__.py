"""pyspark-bigdl import path: bigdl_torch.nn.keras (⟦«py»/nn/keras/⟧)."""
from bigdl_torch.nn.keras import topology, layer  # noqa: F401
