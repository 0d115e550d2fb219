"""Utilities of the PyTorch/CUDA port (counterpart of
``bigdl_tpu.utils``): module and checkpoint persistence (``serializer``)
and the Caffe loader and persister (``caffe``).  The TensorFlow and
Torch7 codecs are not ported yet (``ROADMAP.md`` item 12)."""

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

__all__ = [
    "CheckpointIntegrityError", "gc_checkpoints",
    "load_checkpoint", "load_latest_checkpoint", "load_module",
    "save_checkpoint", "save_module", "verify_checkpoint",
    "CaffeLoader", "CaffePersister", "load_caffe_model", "load_caffe_weights",
]
