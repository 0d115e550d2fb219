"""Names of the metric families the port's serving tier and trainers
stamp.

Counterpart of the serving section of ``bigdl_tpu/obs/names.py``
(:352-390, :434) and of its optim phase timers (:133): the same ``bigdl_*`` names, and at the mint sites the
same kinds and label names, so that a dashboard reads either package's
engines.  Mint sites use these constants, never string literals.  The
JAX package's other families, and its declaration registry with the
strict check that rejects an undeclared name, join when the modules
that need them are ported (the ``obs/server`` slice).
"""

# counter, labels (engine, status)
SERVE_REQUESTS_TOTAL = "bigdl_serve_requests_total"
# histogram, labels (engine, kind)
REQUEST_LATENCY_SECONDS = "bigdl_request_latency_seconds"
# counter
SERVE_TOKENS_TOTAL = "bigdl_serve_tokens_total"
# gauge
SERVE_BATCH_OCCUPANCY = "bigdl_serve_batch_occupancy"
# gauge
SERVE_QUEUE_DEPTH = "bigdl_serve_queue_depth"
# counter
SERVE_PREEMPTIONS_TOTAL = "bigdl_serve_preemptions_total"
# counter
SERVE_REJECTS_TOTAL = "bigdl_serve_rejects_total"
# counter, labels (version)
SERVE_WEIGHT_SWAPS_TOTAL = "bigdl_serve_weight_swaps_total"

# histogram, labels (phase): the trainers' phase timers (optim/metrics.py),
# minted in each trainer's own registry, so not among ``__all__``, the
# families of the serving tier's process-wide registry
PHASE_SECONDS = "bigdl_phase_seconds"

__all__ = ["SERVE_REQUESTS_TOTAL", "REQUEST_LATENCY_SECONDS",
           "SERVE_TOKENS_TOTAL", "SERVE_BATCH_OCCUPANCY", "SERVE_QUEUE_DEPTH",
           "SERVE_PREEMPTIONS_TOTAL", "SERVE_REJECTS_TOTAL",
           "SERVE_WEIGHT_SWAPS_TOTAL"]
