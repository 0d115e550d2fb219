"""Fault tolerance of the port (counterpart of
``bigdl_tpu.resilience``): the trainers' retry policy and its error
classes, and the serving router's retry budget."""

from bigdl_tpu_torch.resilience.retry import (CheckpointWriteError,
                                              NonFiniteStepError,
                                              PeerLostError, RetryBudget,
                                              RetryPolicy, backoff_delay,
                                              classify)

__all__ = ["CheckpointWriteError", "NonFiniteStepError", "PeerLostError",
           "RetryBudget", "RetryPolicy", "backoff_delay", "classify"]
