"""⟦«py»/keras/converter.py⟧ — Keras-1.2.2 JSON/HDF5 model importer."""
from bigdl_tpu_torch.keras.converter import *  # noqa: F401,F403
