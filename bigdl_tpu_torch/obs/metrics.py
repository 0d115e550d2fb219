"""Labelled Counter / Gauge / Histogram registry.

Counterpart of ``bigdl_tpu/obs/metrics.py`` (:83-330): monotonic
:class:`Counter`, settable :class:`Gauge` and bucketed
:class:`Histogram` children, each family optionally labelled (children
made lazily per label combination), thread-safe (engine loops, HTTP
handler threads and clients stamp them at once).  Registration is
idempotent for the same kind and label names and raises for another.
The Prometheus text export and the strict-declaration check wait for
the ``obs/server`` slice.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

# bucket bounds from sub-millisecond host work up to multi-second
# requests
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Counter:
    """Monotonic counter child."""

    kind = "counter"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self.value += amount
        return self


class Gauge:
    """Settable gauge child."""

    kind = "gauge"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float):
        with self._lock:
            self.value = float(value)
        return self

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount
        return self


class Histogram:
    """Bucketed histogram child: per-bucket counts (the last bucket is
    +Inf), the count and the sum."""

    kind = "histogram"

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += v
        return self

    def snapshot_state(self):
        """``(bucket_counts, count, sum)`` under one lock, so a reader
        racing ``observe`` never sees a count that disagrees with the
        buckets."""
        with self._lock:
            return list(self.bucket_counts), self.count, self.sum

    def cumulative(self):
        """[(upper bound, cumulative count), ...] ending with +Inf."""
        counts, _, _ = self.snapshot_state()
        out, acc = [], 0
        for b, c in zip(self.bounds + (float("inf"),), counts):
            acc += c
            out.append((b, acc))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named family: fixed label names, children made lazily per
    label-value combination.  A label-less family acts as its one
    child (``inc``/``set``/``observe``)."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self._children: Dict[tuple, object] = {}

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} do not match "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                cls = _KINDS[self.kind]
                child = (cls(self._lock, self.buckets)
                         if self.kind == "histogram" else cls(self._lock))
                self._children[key] = child
            return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        return self.labels()

    def inc(self, amount: float = 1.0):
        return self._solo().inc(amount)

    def set(self, value: float):
        return self._solo().set(value)

    def observe(self, value: float):
        return self._solo().observe(value)

    def child_items(self):
        with self._lock:
            return list(self._children.items())

    def clear(self):
        """Drop every child (JAX ``_Family.clear``)."""
        with self._lock:
            self._children.clear()


class MetricsRegistry:
    """Named families.  Registering a name again returns its family if
    the kind and label names agree, and raises if they do not."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name, help, kind, labels=(), buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{tuple(labels)}")
                return fam
            fam = _Family(name, help, kind, tuple(labels), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family(name, help, "histogram", labels, buckets)

    def families(self):
        with self._lock:
            return list(self._families.values())


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]
