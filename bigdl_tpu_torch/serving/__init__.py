"""Serving tier of the PyTorch/CUDA port (counterpart of
``bigdl_tpu.serving``): the paged KV cache, the continuous-batching
``LMEngine``, the bounded request queue, the micro-batching
``ClassifierEngine`` and the stdlib HTTP ``ServingServer``; above them
the router tier (session-affine, KV-pressure-aware placement, drain
with exactly-once handoff, budgeted retries and 503 shedding), the
live weight rollout (verified hot swap, canary with auto-rollback) and
the span names of request tracing (``spans``)."""

from bigdl_tpu_torch.serving import spans
from bigdl_tpu_torch.serving.batcher import RequestQueue, ServeRequest
from bigdl_tpu_torch.serving.cache import PagedKVCache, gather_pages
from bigdl_tpu_torch.serving.classifier import ClassifierEngine
from bigdl_tpu_torch.serving.drain import (HANDOFF_ERROR, HandoffLedger,
                                           HandoffRecord, drain_engine)
from bigdl_tpu_torch.serving.engine import LMEngine, paged_decode_math
from bigdl_tpu_torch.serving.placement import (NoReplicaAvailable,
                                               PlacementPolicy, ReplicaView)
from bigdl_tpu_torch.serving.rollout import (CanaryController,
                                             CheckpointWatcher,
                                             publish_checkpoint,
                                             token_divergence)
from bigdl_tpu_torch.serving.router import (EngineReplica, HTTPReplica,
                                            ReplicaDraining,
                                            ReplicaUnavailable, Router,
                                            RouterServer, RouterShed)
from bigdl_tpu_torch.serving.server import ServingServer

__all__ = ["CanaryController", "CheckpointWatcher", "ClassifierEngine",
           "EngineReplica", "HANDOFF_ERROR", "HTTPReplica", "HandoffLedger",
           "HandoffRecord", "LMEngine", "NoReplicaAvailable", "PagedKVCache",
           "PlacementPolicy", "ReplicaDraining", "ReplicaUnavailable",
           "ReplicaView", "RequestQueue", "Router", "RouterServer",
           "RouterShed", "ServeRequest", "ServingServer", "drain_engine",
           "gather_pages", "paged_decode_math", "publish_checkpoint",
           "spans", "token_divergence"]
