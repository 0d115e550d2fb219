"""Span tracer: Chrome ``trace_event`` JSON and JSONL structured events.

Counterpart of ``bigdl_tpu/obs/trace.py`` (:86-297).  ``Tracer`` nests
spans per thread through a context variable (deterministic ids from a
per-tracer counter), writes one Chrome trace (Perfetto-viewable) and
one JSONL stream a run, and keeps the newest records in memory (the
flight recorder ``recent()``, read by ``/trace?last=K``) and each thread's
stack of live span names (:func:`current_phase`, what the sampling
profiler attributes its stacks to).  It is
thread-safe: the engines' step loops, the HTTP handler threads and the
rollout's watcher record into one tracer.

Off by default: with ``BIGDL_TORCH_TRACE_DIR`` unset, callers get the
shared :data:`NULL_TRACER`, whose ``span()`` returns one reusable no-op
context manager (no allocation, no clock read).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time

# the active span id of the current thread or task (None at top level)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "bigdl_torch_obs_span", default=None)

# the live span names of each thread, innermost last: what the sampling
# profiler (obs/prof.py) prefixes its stacks with (JAX :44-85).  One
# list a thread ident; a push or a pop is one list operation under the
# GIL, and the profiler reads without a lock (a sample that lands in a
# push or pop counts to the neighbouring span)
_PHASES: dict = {}


def current_phase(ident: int):
    """The innermost live span name of thread ``ident``, None outside
    every recorded span.  Never raises: the stack may go between the
    lookup and the index."""
    try:
        return _PHASES[ident][-1]
    except (KeyError, IndexError):
        return None


def _push_phase(name: str) -> int:
    ident = threading.get_ident()
    _PHASES.setdefault(ident, []).append(name)
    return ident


def _pop_phase(ident: int):
    try:
        stack = _PHASES[ident]
        stack.pop()
        if not stack:
            del _PHASES[ident]
    except (KeyError, IndexError):  # torn by a concurrent reset
        pass


def _host_id() -> int:
    """This process's rank in a torch.distributed world (0 outside one):
    the tag that tells merged shards apart."""
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0
    except Exception:  # noqa: BLE001 — tracing must never fail start-up
        return 0


class _NullSpan:
    """Reusable no-op context manager: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer with the whole :class:`Tracer` surface."""

    __slots__ = ()
    enabled = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def event(self, name, **attrs):
        pass

    def complete(self, name, start_perf, duration_s, **attrs):
        pass

    def counter(self, name, **values):
        pass

    def recent(self):
        return []

    def flush(self):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer bound to one output directory.  File names carry
    the host rank, the pid and a process-wide counter, so two tracers
    never share a file."""

    enabled = True
    _FILE_SEQ = itertools.count()

    def __init__(self, trace_dir: str, app_name: str = "bigdl_tpu_torch",
                 host_id: int = None, ring_size: int = 512):
        os.makedirs(trace_dir, exist_ok=True)
        self.pid = os.getpid()
        self.host_id = _host_id() if host_id is None else int(host_id)
        stem = (f"{app_name}.h{self.host_id}.{self.pid}."
                f"{next(Tracer._FILE_SEQ)}")
        self.trace_path = os.path.join(trace_dir, stem + ".trace.json")
        self.jsonl_path = os.path.join(trace_dir, stem + ".events.jsonl")
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._events: list = []
        self._tids: dict = {}
        self._closed = False
        self._recent: collections.deque = collections.deque(
            maxlen=max(1, int(ring_size)))
        # one wall-clock anchor and the perf_counter timeline: Chrome
        # wants monotonic microseconds, the JSONL wall time
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()
        self._jsonl = open(self.jsonl_path, "a", encoding="utf-8")
        self._events.append({"name": "process_name", "ph": "M",
                             "pid": self.pid, "tid": 0,
                             "args": {"name":
                                      f"{app_name} host{self.host_id}"}})

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[ident] = tid
                self._events.append(
                    {"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid,
                     "args": {"name": threading.current_thread().name}})
            return tid

    def _record(self, chrome_ev: dict, jsonl_rec: dict = None):
        line = None
        if jsonl_rec is not None:
            jsonl_rec["host"] = self.host_id
            jsonl_rec["pid"] = self.pid
            line = json.dumps(jsonl_rec, default=str) + "\n"
        with self._lock:
            if self._closed:
                return
            self._events.append(chrome_ev)
            if line is not None:
                self._recent.append(jsonl_rec)
                self._jsonl.write(line)

    def recent(self) -> list:
        """The flight-recorder ring: the newest records, oldest first."""
        with self._lock:
            return list(self._recent)

    def _ts_us(self, perf_t: float) -> float:
        return round((perf_t - self._epoch_perf) * 1e6, 3)

    def _wall(self, perf_t: float) -> float:
        return self._epoch_wall + (perf_t - self._epoch_perf)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed nested span; yields its span id."""
        sid = next(self._ids)
        parent = _CURRENT.get()
        token = _CURRENT.set(sid)
        ident = _push_phase(name)
        tid = self._tid()
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            _CURRENT.reset(token)
            _pop_phase(ident)
            dur = time.perf_counter() - t0
            self._record(
                {"name": name, "ph": "X", "ts": self._ts_us(t0),
                 "dur": round(dur * 1e6, 3), "pid": self.pid, "tid": tid,
                 "args": attrs},
                {"kind": "span", "name": name, "id": sid, "parent": parent,
                 "tid": tid, "wall_time": self._wall(t0),
                 "dur_s": round(dur, 9), "attrs": attrs})

    def event(self, name: str, **attrs):
        """Instant structured event."""
        t = time.perf_counter()
        tid = self._tid()
        self._record(
            {"name": name, "ph": "i", "s": "t", "ts": self._ts_us(t),
             "pid": self.pid, "tid": tid, "args": attrs},
            {"kind": "event", "name": name, "id": next(self._ids),
             "parent": _CURRENT.get(), "tid": tid,
             "wall_time": self._wall(t), "attrs": attrs})

    def complete(self, name: str, start_perf: float, duration_s: float,
                 **attrs):
        """Retroactive span from a ``perf_counter()`` start and a
        duration (the request tracer's kept hops)."""
        tid = self._tid()
        self._record(
            {"name": name, "ph": "X", "ts": self._ts_us(start_perf),
             "dur": round(duration_s * 1e6, 3), "pid": self.pid,
             "tid": tid, "args": attrs},
            {"kind": "span", "name": name, "id": next(self._ids),
             "parent": _CURRENT.get(), "tid": tid,
             "wall_time": self._wall(start_perf),
             "dur_s": round(duration_s, 9), "attrs": attrs})

    def counter(self, name: str, **values):
        """Chrome counter track."""
        t = time.perf_counter()
        self._record({"name": name, "ph": "C", "ts": self._ts_us(t),
                      "pid": self.pid, "tid": 0, "args": values})

    def flush(self):
        """Write the whole Chrome trace (atomic replace) and flush the
        JSONL stream; the trace file is valid after every flush."""
        with self._lock:
            events = list(self._events)
            if not self._jsonl.closed:
                self._jsonl.flush()
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"pid": self.pid, "host_id": self.host_id,
                             "wall_epoch": self._epoch_wall}}
        tmp = self.trace_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        os.replace(tmp, self.trace_path)

    def close(self):
        """Flush and stop recording (idempotent)."""
        if self._closed:
            return
        self.flush()
        with self._lock:
            self._closed = True
            if not self._jsonl.closed:
                self._jsonl.close()


__all__ = ["NullTracer", "NULL_TRACER", "Tracer", "current_phase"]
