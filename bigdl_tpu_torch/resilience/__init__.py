"""Fault tolerance of the port's trainers (counterpart of
``bigdl_tpu.resilience``): the retry policy and its error classes."""

from bigdl_tpu_torch.resilience.retry import (CheckpointWriteError,
                                              NonFiniteStepError,
                                              PeerLostError, RetryPolicy,
                                              backoff_delay, classify)

__all__ = ["CheckpointWriteError", "NonFiniteStepError", "PeerLostError",
           "RetryPolicy", "backoff_delay", "classify"]
