"""Serving tier of the PyTorch/CUDA port (counterpart of
``bigdl_tpu.serving``)."""

from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.cache import PagedKVCache, gather_pages
from bigdl_tpu_torch.serving.classifier import ClassifierEngine
from bigdl_tpu_torch.serving.drain import (HANDOFF_ERROR, HandoffLedger,
                                           HandoffRecord, drain_engine)
from bigdl_tpu_torch.serving.engine import LMEngine, paged_decode_math
from bigdl_tpu_torch.serving.server import ServingServer

__all__ = ["ClassifierEngine", "HANDOFF_ERROR", "HandoffLedger",
           "HandoffRecord", "LMEngine", "PagedKVCache", "RequestQueue",
           "ServeRequest", "ServingServer", "drain_engine", "gather_pages",
           "paged_decode_math"]
