"""⟦«py»/nn/keras/topology.py⟧ — Sequential Keras-style model (on
``device``, the card by default).  The functional graph API is
``bigdl_torch.nn.layer.Model`` (node-based)."""
from bigdl_tpu_torch.keras.models import Sequential  # noqa: F401
