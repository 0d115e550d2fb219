"""⟦«py»/nn/keras/layer.py⟧ — Keras-style layer spellings."""
from bigdl_tpu_torch.keras.layers import *  # noqa: F401,F403
