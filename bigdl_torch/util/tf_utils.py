"""«py»/util/tf_utils.py shim — TF graph import/export entry points."""

from bigdl_tpu_torch.utils.tf_interop import (  # noqa: F401
    BigDLSessionImpl,
    TensorflowLoader,
    TensorflowSaver,
    TFTrainingSession,
    load_tf,
)
