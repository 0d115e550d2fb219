"""Utilities of the PyTorch/CUDA port (counterpart of
``bigdl_tpu.utils``): module and checkpoint persistence
(``serializer``), the Caffe loader and persister (``caffe``), the
TensorFlow GraphDef loader and saver (``tf_interop``) and the Torch7
``.t7`` codec (``torch_file``)."""

from bigdl_tpu_torch.utils.caffe import (CaffeLoader, CaffePersister,
                                         load_caffe_model,
                                         load_caffe_weights)
from bigdl_tpu_torch.utils.serializer import (CheckpointIntegrityError,
                                              gc_checkpoints,
                                              load_checkpoint,
                                              load_latest_checkpoint,
                                              load_module, save_checkpoint,
                                              save_module,
                                              verify_checkpoint)
from bigdl_tpu_torch.utils.tf_interop import (TensorflowLoader,
                                              TensorflowSaver, load_tf)
from bigdl_tpu_torch.utils.torch_file import (load_t7, load_torch_module,
                                              save_t7)

__all__ = [
    "CheckpointIntegrityError", "gc_checkpoints",
    "load_checkpoint", "load_latest_checkpoint", "load_module",
    "save_checkpoint", "save_module", "verify_checkpoint",
    "CaffeLoader", "CaffePersister", "load_caffe_model", "load_caffe_weights",
    "TensorflowLoader", "TensorflowSaver", "load_tf",
    "load_t7", "load_torch_module", "save_t7",
]
