"""Error classification and the retry policy of the trainers.

Counterpart of ``bigdl_tpu/resilience/retry.py``: the error classes
(:45-57), ``classify`` (:79), ``backoff_delay`` (:95) and
``RetryPolicy`` (:163).  ``DistriOptimizer.optimize`` asks ``classify``
whether a failure is ``"transient"`` (back off, reload the newest
intact checkpoint, go on) or ``"fatal"`` (raise at once: a bad
configuration cannot get better by retrying).  The serving router's
``RetryBudget`` is not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Optional


class NonFiniteStepError(RuntimeError):
    """Too many consecutive training steps with a non-finite loss or
    gradient: escalated from skipping steps to the retry policy."""


class CheckpointWriteError(RuntimeError):
    """A checkpoint write failed; retrying on top of a broken sink only
    loses more progress, so this is fatal."""


class PeerLostError(RuntimeError):
    """A peer of a multi-process run is gone; a retry at the same world
    size would hang in the next collective, so this is fatal."""


# configuration and programming errors: retrying cannot change them
FATAL_TYPES = (ValueError, TypeError, KeyError, IndexError, AttributeError,
               NotImplementedError, AssertionError, ImportError,
               UnicodeError)


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry from a checkpoint) or ``"fatal"``."""
    if not isinstance(exc, Exception):
        return "fatal"      # KeyboardInterrupt, SystemExit, GeneratorExit
    if isinstance(exc, NonFiniteStepError):
        return "transient"
    if isinstance(exc, (CheckpointWriteError, PeerLostError)):
        return "fatal"
    if isinstance(exc, FATAL_TYPES):
        return "fatal"
    # OSError, RuntimeError (CUDA and NCCL errors among them),
    # MemoryError and the unknown rest: the reference retried them all
    return "transient"


def backoff_delay(attempt: int, base: float = 0.5, cap: float = 30.0,
                  jitter: float = 0.1,
                  rng: Optional[random.Random] = None) -> float:
    """``min(cap, base * 2^(attempt-1)) * (1 + jitter * U[0, 1))`` for
    the 1-based ``attempt``; a seeded ``rng`` makes it reproducible."""
    delay = min(float(cap), float(base) * (2.0 ** (max(1, int(attempt)) - 1)))
    u = rng.random() if rng is not None else random.random()
    return delay * (1.0 + float(jitter) * u)


class RetryPolicy:
    """Backoff with a per-run attempt cap and a sliding-window budget.
    ``record_failure`` gives the seconds to wait before the next
    attempt, or ``None`` when the caller must raise."""

    def __init__(self, max_retries: int = 5, backoff_base: float = 0.5,
                 backoff_max: float = 30.0, jitter: float = 0.1,
                 window_seconds: float = 600.0, window_budget: int = 16,
                 seed: int = 0):
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.window_seconds = float(window_seconds)
        self.window_budget = int(window_budget)
        self.attempts = 0
        self._window = deque()
        self._rng = random.Random(seed)

    @classmethod
    def from_config(cls, max_retries: Optional[int] = None) -> "RetryPolicy":
        from bigdl_tpu_torch.config import TrainConfig

        cfg = TrainConfig.from_env()
        return cls(max_retries=5 if max_retries is None else max_retries,
                   backoff_base=cfg.retry_backoff_base,
                   backoff_max=cfg.retry_backoff_max,
                   window_seconds=cfg.retry_window_seconds,
                   window_budget=cfg.retry_window_budget)

    def record_failure(self, exc: Optional[BaseException] = None,
                       now: Optional[float] = None) -> Optional[float]:
        """Count one transient failure at ``now`` (monotonic seconds)."""
        del exc
        t = time.monotonic() if now is None else now
        self.attempts += 1
        self._window.append(t)
        while self._window and self._window[0] < t - self.window_seconds:
            self._window.popleft()
        if self.attempts > self.max_retries:
            return None
        if len(self._window) > self.window_budget:
            return None
        return backoff_delay(self.attempts, base=self.backoff_base,
                             cap=self.backoff_max, jitter=self.jitter,
                             rng=self._rng)


__all__ = ["NonFiniteStepError", "CheckpointWriteError", "PeerLostError",
           "FATAL_TYPES", "classify", "backoff_delay",
           "RetryPolicy"]
