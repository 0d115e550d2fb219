"""Serving tier of the PyTorch/CUDA port (counterpart of
``bigdl_tpu.serving``)."""

from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.cache import PagedKVCache, gather_pages
from bigdl_tpu_torch.serving.engine import LMEngine, paged_decode_math

__all__ = ["LMEngine", "PagedKVCache", "RequestQueue", "ServeRequest",
           "gather_pages", "paged_decode_math"]
