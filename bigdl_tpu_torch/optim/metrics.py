"""Metrics: the trainers' per-phase timers.

Counterpart of ``bigdl_tpu/optim/metrics.py`` (:29-94): one
``bigdl_phase_seconds`` histogram family labelled by ``phase``, in the
port's own registry (``obs/metrics.py``), with the reference's phase
names as the label values ("computing time", "data wait time", "put
batch time"), so a log parser or dashboard reads either package's
trainers.  Each trainer owns a private registry unless it is given one.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

from bigdl_tpu_torch.obs import names
from bigdl_tpu_torch.obs.metrics import MetricsRegistry

# from ~100 µs host phases up to multi-second validation or checkpoints
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Metrics:
    """Per-phase timer facade over a metrics registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._family = self.registry.histogram(
            names.PHASE_SECONDS,
            "Per-phase host wall time (reference Metrics.scala names)",
            labels=("phase",), buckets=PHASE_BUCKETS)

    def _child(self, name: str):
        return self._family.labels(phase=name)

    def add(self, name: str, value: float) -> None:
        self._child(name).observe(float(value))

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def value(self, name: str) -> float:
        """Mean seconds per observation (the reference's "average")."""
        _, count, total = self._child(name).snapshot_state()
        return total / count if count else 0.0

    def count(self, name: str) -> int:
        return self._child(name).count

    def total(self, name: str) -> float:
        return self._child(name).sum

    def snapshot(self) -> dict:
        """{phase: {count, total, mean}}, each phase read under one
        lock."""
        out = {}
        for (phase,), child in self._family.child_items():
            _, count, total = child.snapshot_state()
            out[phase] = {"count": count, "total": total,
                          "mean": total / count if count else 0.0}
        return out

    def summary(self) -> str:
        """The log line, in the reference's "<phase> average: Xms"
        spelling with the count and total appended."""
        return ", ".join(
            f"{k} average: {v['mean'] * 1000:.2f}ms "
            f"(n={v['count']}, total={v['total'] * 1000:.1f}ms)"
            for k, v in sorted(self.snapshot().items()))

    def reset(self) -> None:
        self._family.clear()


__all__ = ["Metrics", "PHASE_BUCKETS"]
