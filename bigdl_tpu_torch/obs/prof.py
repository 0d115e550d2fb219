"""Continuous sampling profiler — always-on, span-attributed, capped.

Counterpart of ``bigdl_tpu/obs/prof.py``: the same fold table, budget,
snapshot and collapsed text.  One difference: the sampling work the
budget caps leaves out the garbage collector's passes that happen to
start on the sampler's thread.  A full pass over a training process's
heap takes tens of milliseconds and lands on whichever thread crosses
the allocation threshold; charged to one sample, it held the ratio past
the budget for seconds.

The observability stack can *detect* trouble (alerts, request traces,
fleet rollups) but could not answer "what was the process actually
doing when the alert fired" — by the time a human attaches a profiler,
the p99 spike is gone.  This module is the standard closing move: a
daemon thread walks ``sys._current_frames()`` at ``BIGDL_TORCH_PROF_HZ`` and
folds every thread's stack into a bounded collapsed-stack table, so a
profile is *always* available — to ``GET /profilez``, to the debug
bundles (obs/bundle.py), and to the report's "profiles" section.

Two properties make it safe to leave on in production:

* **Span attribution.**  Each sampled stack is prefixed with the
  innermost live span name of its thread (the tracer's per-thread
  phase stack, :func:`bigdl_tpu_torch.obs.trace.current_phase`), so output
  reads ``serve.decode_step;engine.py:_step;...  61`` — "the decode
  step spends 61% here" — not anonymous frames.  Threads outside any
  span fold under ``(no span)``.
* **Hard overhead cap.**  The cumulative sampling-work ratio
  (seconds spent walking/folding / wall seconds) is published as
  ``bigdl_prof_overhead_ratio`` and checked *before* every sample:
  over ``BIGDL_TORCH_PROF_BUDGET`` the sample is skipped (and counted in
  ``bigdl_prof_skipped_total``) until the ratio recovers.  A
  misconfigured 10 kHz profiler degrades to the budget, never past it.

Off by default: ``BIGDL_TORCH_PROF_HZ`` unset/<=0 yields the shared
:data:`NULL_PROFILER` — no thread, no clock reads, the disabled path
is one config read (the same null-object contract as NULL_TRACER).
"""

from __future__ import annotations

import gc
import json
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from bigdl_tpu_torch.obs import names, trace

log = logging.getLogger("bigdl_tpu_torch.obs")

#: bounded fold table: distinct collapsed stacks kept before new ones
#: fold into the per-phase ``(other)`` bucket
MAX_STACKS = 2048
#: frames walked per sampled stack (deeper stacks truncate at the root)
MAX_DEPTH = 64
#: label attributed to a sampled thread with no live span
NO_SPAN = "(no span)"
#: overflow stack suffix once the fold table is full
OTHER = "(other)"


def _frame_label(frame) -> str:
    """``file.py:func`` — base name only; full paths explode the fold
    table across venvs without adding attribution value."""
    code = frame.f_code
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class NullProfiler:
    """No-op profiler with the full :class:`SamplingProfiler` surface —
    the pinned zero-overhead off path (no thread, no state)."""

    __slots__ = ()
    enabled = False
    hz = 0.0

    def snapshot(self) -> dict:
        return {"enabled": False, "hz": 0.0, "samples": 0,
                "skipped": 0, "overhead_ratio": 0.0, "stacks": 0,
                "phases": {}, "collapsed": []}

    def render_collapsed(self) -> str:
        return ""

    def close(self):
        pass


NULL_PROFILER = NullProfiler()


class SamplingProfiler:
    """One daemon thread sampling every live thread's stack at ``hz``.

    All mutation happens on the sampler thread; readers
    (:meth:`snapshot`, the /profilez handler, bundle builds) copy
    under the lock.  The sampler never touches the thread it runs on.
    """

    enabled = True

    def __init__(self, hz: float, budget: float = 0.01,
                 clock: Callable[[], float] = time.perf_counter,
                 work_clock: Callable[[], float] = time.perf_counter):
        self.hz = float(hz)
        self.budget = float(budget)
        # the wall clock, and the clock a sample's work is counted on
        # (injectable for tests)
        self._clock = clock
        self._work_clock = work_clock
        # collector passes run on the sampler's thread: timed apart
        self._ident = None
        self._gc_s = 0.0
        self._gc_t0 = None
        gc.callbacks.append(self._on_gc)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        # (phase, leaf frame) -> samples: the "top self-time frames per
        # phase" table the report renders
        self._self: Dict[tuple, int] = {}
        self._samples = 0
        self._skipped = 0
        self._work_s = 0.0
        self._started = clock()
        self._stop = threading.Event()
        from bigdl_tpu_torch import obs

        reg = obs.get_registry()
        self._samples_c = reg.counter(
            names.PROF_SAMPLES_TOTAL,
            "Stack samples folded into the collapsed-stack table")
        self._skipped_c = reg.counter(
            names.PROF_SKIPPED_TOTAL,
            "Samples skipped by the overhead budget")
        self._overhead_g = reg.gauge(
            names.PROF_OVERHEAD_RATIO,
            "Profiler self-overhead ratio (work seconds / wall seconds)")
        self._stacks_g = reg.gauge(
            names.PROF_STACKS,
            "Distinct collapsed stacks in the bounded fold table")
        self._thread = threading.Thread(
            target=self._run, name="bigdl-prof", daemon=True)
        self._thread.start()
        log.info("obs.prof: continuous profiler on at %.1f Hz "
                 "(budget %.3f)", self.hz, self.budget)

    # -------------------------------------------------------------- core
    def overhead_ratio(self) -> float:
        wall = self._clock() - self._started
        return self._work_s / max(wall, 1e-9)

    def _run(self):
        period = 1.0 / max(self.hz, 1e-6)
        me = threading.get_ident()
        while not self._stop.wait(period):
            self._tick(me)

    def _tick(self, me: int) -> bool:
        """One period: the budget check, then (within budget) one
        sample.  Returns whether it sampled."""
        ratio = self.overhead_ratio()
        self._overhead_g.set(ratio)
        if ratio > self.budget:
            # the hard cap: over budget, the profiler degrades to
            # bookkeeping-only until the ratio recovers
            self._skipped += 1
            self._skipped_c.inc()
            return False
        self._ident = threading.get_ident()
        gc0 = self._gc_s
        t0 = self._work_clock()
        try:
            self._sample(me)
        except Exception:  # noqa: BLE001 — profiling never kills a host
            log.exception("obs.prof: sample failed; continuing")
        self._work_s += max(0.0, self._work_clock() - t0
                            - (self._gc_s - gc0))
        return True

    def _on_gc(self, phase: str, info: dict):
        """Time the collector's passes that start on the sampler's
        thread: a pass runs wherever the allocation count crosses its
        threshold, it would have run on another thread a few allocations
        later, and a full pass over a training process's heap costs tens
        of milliseconds the budget must not charge to one sample."""
        if threading.get_ident() != self._ident:
            return
        if phase == "start":
            self._gc_t0 = self._work_clock()
        elif self._gc_t0 is not None:
            self._gc_s += self._work_clock() - self._gc_t0
            self._gc_t0 = None

    def _sample(self, me: int):
        frames = sys._current_frames()
        with self._lock:
            for ident, frame in frames.items():
                if ident == me:
                    continue
                phase = trace.current_phase(ident) or NO_SPAN
                parts = []
                leaf = _frame_label(frame)
                f = frame
                while f is not None and len(parts) < MAX_DEPTH:
                    parts.append(_frame_label(f))
                    f = f.f_back
                # root-first, phase as the fold root
                key = phase + ";" + ";".join(reversed(parts))
                if key not in self._counts \
                        and len(self._counts) >= MAX_STACKS:
                    key = phase + ";" + OTHER
                self._counts[key] = self._counts.get(key, 0) + 1
                sk = (phase, leaf)
                self._self[sk] = self._self.get(sk, 0) + 1
            self._samples += 1
        self._samples_c.inc()
        self._stacks_g.set(len(self._counts))

    # ------------------------------------------------------------ readers
    def snapshot(self, top: int = 8) -> dict:
        """JSON-able profile state: totals, overhead, and the top
        self-time frames per phase (what the report + bundles carry)."""
        with self._lock:
            counts = dict(self._counts)
            self_t = dict(self._self)
            samples, skipped = self._samples, self._skipped
        phases: Dict[str, dict] = {}
        for (phase, leaf), n in self_t.items():
            p = phases.setdefault(phase, {"samples": 0, "frames": {}})
            p["samples"] += n
            p["frames"][leaf] = p["frames"].get(leaf, 0) + n
        for p in phases.values():
            p["frames"] = sorted(p["frames"].items(),
                                 key=lambda kv: -kv[1])[:max(1, top)]
        collapsed = sorted(counts.items(), key=lambda kv: -kv[1])
        return {
            "enabled": True,
            "hz": self.hz,
            "budget": self.budget,
            "samples": samples,
            "skipped": skipped,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "stacks": len(counts),
            "phases": phases,
            "collapsed": [f"{k} {v}" for k, v in collapsed],
        }

    def render_collapsed(self) -> str:
        """The folded-stack text format every flamegraph tool eats:
        one ``stack count`` line per distinct collapsed stack."""
        with self._lock:
            counts = sorted(self._counts.items(), key=lambda kv: -kv[1])
        return "".join(f"{k} {v}\n" for k, v in counts)

    def close(self):
        """Stop the sampler thread (idempotent)."""
        try:
            gc.callbacks.remove(self._on_gc)
        except ValueError:
            pass
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


# ------------------------------------------------------------- singleton
_lock = threading.Lock()
_profiler = NULL_PROFILER
_profiler_key = None


def get_profiler():
    """The process profiler — a :class:`SamplingProfiler` when
    ``BIGDL_TORCH_PROF_HZ`` > 0, the shared :data:`NULL_PROFILER` otherwise
    (no thread ever starts on the off path).  Rebuilt when the
    hz/budget config changes."""
    global _profiler, _profiler_key
    from bigdl_tpu_torch.config import refresh_from_env

    cfg = refresh_from_env().obs
    key = (cfg.prof_hz, cfg.prof_budget)
    with _lock:
        if key == _profiler_key:
            return _profiler
        if _profiler is not NULL_PROFILER:
            _profiler.close()
        _profiler_key = key
        _profiler = (SamplingProfiler(cfg.prof_hz, cfg.prof_budget)
                     if cfg.prof_hz > 0 else NULL_PROFILER)
        return _profiler


def current():
    """The live profiler WITHOUT building one — cheap reads (health
    payloads, report columns) must not start a sampler thread as a
    side effect."""
    return _profiler


def reset_profiler():
    """Test hook: stop the sampler; the next accessor rebuilds."""
    global _profiler, _profiler_key
    with _lock:
        if _profiler is not NULL_PROFILER:
            _profiler.close()
        _profiler = NULL_PROFILER
        _profiler_key = None


def write_profile(out_dir: str, stem: str) -> Optional[str]:
    """One ``<stem>.profile.json`` shard in ``out_dir`` (the obs.flush
    hook — how an offline report gets the run's folded profile); None
    when the profiler is off or has no samples yet."""
    prof = _profiler
    if prof is NULL_PROFILER:
        return None
    snap = prof.snapshot()
    if not snap["samples"]:
        return None
    path = os.path.join(out_dir, stem + ".profile.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(snap, fh)
    os.replace(tmp, path)
    return path


__all__ = ["MAX_STACKS", "MAX_DEPTH", "NO_SPAN", "OTHER", "NullProfiler",
           "NULL_PROFILER", "SamplingProfiler", "get_profiler", "current",
           "reset_profiler", "write_profile"]
