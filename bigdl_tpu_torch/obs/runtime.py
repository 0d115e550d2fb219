"""Runtime profile: step-time reservoirs and memory.

Counterpart of ``bigdl_tpu/obs/runtime.py`` (:1-307): :class:`Reservoir`
(the newest N observations, nearest-rank p50/p95/p99, deterministic),
:func:`host_rss_bytes`, :class:`RuntimeStats` and the device memory of
``torch.cuda.memory_stats`` / ``max_memory_allocated``.  The JAX
module's ``instrument_jit``, ``hlo_cost_analysis`` and its compile
events have no counterpart (nothing is jit-compiled here); the trainers
record each step's time (dispatch to the loss read) and its dispatch
time (the host's share of queueing the step) instead.  Host-side
bookkeeping only: nothing here synchronizes the card.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional, Sequence

DEFAULT_RESERVOIR = 4096
_PCTS = (0.5, 0.95, 0.99)


class Reservoir:
    """Ring buffer of the most recent ``size`` observations with
    nearest-rank percentiles.  Deterministic: same inputs, same
    percentiles — no random replacement."""

    def __init__(self, size: int = DEFAULT_RESERVOIR):
        self.size = max(1, int(size))
        self._buf: list = []
        self._idx = 0
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def add(self, value: float):
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            if len(self._buf) < self.size:
                self._buf.append(v)
            else:
                self._buf[self._idx] = v
                self._idx = (self._idx + 1) % self.size

    def percentiles(self, qs: Sequence[float] = _PCTS) -> dict:
        """{q: nearest-rank value} over the retained window; None when
        empty."""
        with self._lock:
            buf = sorted(self._buf)
        out = {}
        for q in qs:
            if not buf:
                out[q] = None
            else:
                k = min(len(buf) - 1, max(0, math.ceil(q * len(buf)) - 1))
                out[q] = buf[k]
        return out

    def summary(self) -> dict:
        p = self.percentiles()
        return {"p50": p[0.5], "p95": p[0.95], "p99": p[0.99],
                "count": self.count,
                "total_s": round(self.total, 6),
                "mean": self.total / self.count if self.count else None}


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None when unknowable."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001 — best-effort on exotic hosts
            return None


_HBM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _cuda_stats(index: int) -> Optional[dict]:
    import torch

    stats = torch.cuda.memory_stats(index)
    if not stats:
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                index).total_memory)}


def device_memory_stats(device=None) -> Optional[dict]:
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` of the current
    CUDA device (or ``device``) from the caching allocator; None
    without a card, and None in a process that has not initialized CUDA
    (reading would initialize it: the restart supervisor flushes its
    telemetry this way and must leave the card to its children)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        index = torch.cuda.current_device() if device is None \
            else torch.device(device).index or 0
        return _cuda_stats(index)
    except Exception:  # noqa: BLE001 — best-effort telemetry
        return None


def all_device_memory_stats() -> Optional[dict]:
    """:func:`device_memory_stats` of every visible card, ``{index:
    stats}``; None without a card or before CUDA is initialized."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        out = {}
        for i in range(torch.cuda.device_count()):
            stats = _cuda_stats(i)
            if stats:
                out[i] = stats
        return out or None
    except Exception:  # noqa: BLE001 — best-effort telemetry
        return None


class RuntimeStats:
    """The process's runtime profile: step and dispatch times."""

    def __init__(self, reservoir_size: int = DEFAULT_RESERVOIR):
        self.step_times = Reservoir(reservoir_size)
        self.dispatch_times = Reservoir(reservoir_size)

    def record_step(self, seconds: float):
        """One train step's time, dispatch to the resolved loss."""
        self.step_times.add(seconds)

    def record_dispatch(self, name: str, seconds: float):
        """The host's time to queue one step."""
        del name
        self.dispatch_times.add(seconds)

    def snapshot(self, memory: bool = True) -> dict:
        out = {"step_time_s": self.step_times.summary(),
               "dispatch_time_s": self.dispatch_times.summary()}
        if memory:
            out["host_rss_bytes"] = host_rss_bytes()
            dm = device_memory_stats()
            if dm is not None:
                out["device_memory"] = dm
            dma = all_device_memory_stats()
            if dma is not None:
                out["device_memory_all"] = dma
        return out

    def reset(self):
        self.__init__(self.step_times.size)


__all__ = ["Reservoir", "RuntimeStats", "host_rss_bytes",
           "device_memory_stats", "all_device_memory_stats"]
