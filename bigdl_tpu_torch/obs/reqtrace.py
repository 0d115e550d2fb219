"""Request tracing with tail sampling.

Counterpart of ``bigdl_tpu/obs/reqtrace.py``:

* :class:`RequestTraceContext` (:50-98): one trace id, an optional
  parent span and a force-keep flag, minted at the first hop (the
  router's ``route``, ``RouterServer`` or ``LMEngine.submit``) and
  carried across HTTP hops in the ``X-Bigdl-Trace`` header as
  ``<trace_id>:<parent>:<flags>`` and into a drain's handoff record;
* :class:`ReqTraceCollector` (:108-321): a per-process buffer of the
  hop spans of each open trace.  Spans are buffered until the request
  completes; the completion then decides: keep always when the request
  errored, was handed off, preempted, retried, broke its SLO or carries
  the force-keep flag, else keep when a hash of the trace id falls
  under ``BIGDL_TORCH_REQTRACE_SAMPLE`` (so every process keeps or drops
  the same trace).  Kept spans go to the process tracer and into a
  bounded ring that ``/trace?request=ID`` reads.

``BIGDL_TORCH_REQTRACE_SAMPLE=0`` (the default) gives the null
collector: no contexts minted, nothing buffered, and the engine carries
no trace state.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.config import obs_knob_key

#: the HTTP propagation header: ``<trace_id>:<parent_span>:<flags>``
TRACE_HEADER = "X-Bigdl-Trace"

#: the reasons a kept trace may carry (the labels of
#: ``bigdl_reqtrace_sampled_total``)
KEEP_REASONS = ("error", "retry", "preempt", "slo", "handoff", "forced",
                "sampled")


class RequestTraceContext:
    """One request's trace identity."""

    __slots__ = ("trace_id", "parent", "keep")

    def __init__(self, trace_id: str, parent: Optional[int] = None,
                 keep: bool = False):
        self.trace_id = str(trace_id)
        self.parent = parent
        self.keep = bool(keep)

    def to_header(self) -> str:
        parent = "" if self.parent is None else str(self.parent)
        flags = "k" if self.keep else ""
        return f"{self.trace_id}:{parent}:{flags}"

    @classmethod
    def from_header(cls, value: Optional[str]
                    ) -> Optional["RequestTraceContext"]:
        """Tolerant parse of the header: None or a malformed value gives
        None (a bad trace header never fails a request)."""
        if not value:
            return None
        parts = str(value).strip().split(":")
        tid = parts[0].strip()
        if not tid:
            return None
        parent = None
        if len(parts) > 1 and parts[1].strip():
            try:
                parent = int(parts[1])
            except ValueError:
                parent = None
        flags = parts[2] if len(parts) > 2 else ""
        return cls(tid, parent=parent, keep="k" in flags)

    def __repr__(self):
        return (f"RequestTraceContext({self.trace_id!r}, "
                f"parent={self.parent}, keep={self.keep})")


def _hash01(trace_id: str) -> float:
    """A uniform [0, 1) number from the trace id, the same in every
    process, so the probabilistic keep agrees without coordination."""
    h = hashlib.sha256(trace_id.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class ReqTraceCollector:
    """Per-process span buffer, tail sampler and ring of kept traces."""

    def __init__(self, sample: float = 0.0, ring_size: int = 256):
        self.sample = max(0.0, min(1.0, float(sample)))
        self.ring_size = max(1, int(ring_size))
        self.enabled = self.sample > 0.0
        self._lock = threading.Lock()
        self._buffers: Dict[str, List[tuple]] = {}
        self._ring: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        # the first finish's keep/drop decision of each trace, so that
        # the router's and the engine's finish of one trace agree and
        # the sampler's counters count it once
        self._decided: "collections.OrderedDict[str, Tuple[bool, str]]" \
            = collections.OrderedDict()
        from bigdl_tpu_torch import obs
        from bigdl_tpu_torch.obs import names

        reg = obs.get_registry()
        self._sampled = reg.counter(
            names.REQTRACE_SAMPLED_TOTAL,
            "Request traces kept by the tail sampler, by keep reason",
            labels=("reason",))
        self._dropped = reg.counter(
            names.REQTRACE_DROPPED_TOTAL,
            "Completed request traces dropped by the tail sampler")
        self._evicted = reg.counter(
            names.REQTRACE_RING_EVICTED_TOTAL,
            "Kept request traces evicted from the bounded ring")
        self._active = reg.gauge(
            names.REQTRACE_ACTIVE_TRACES,
            "Request traces currently open (begun, not yet sampled)")

    def new_context(self) -> RequestTraceContext:
        return RequestTraceContext(uuid.uuid4().hex[:16])

    def _open(self, trace_id: str) -> Optional[list]:
        """(Re)open a trace's buffer; the caller holds the lock.  A
        dropped trace stays dropped (None); a kept one may reopen, so an
        in-process handoff replay's spans join its ring entry."""
        buf = self._buffers.get(trace_id)
        if buf is None:
            decided = self._decided.get(trace_id)
            if decided is not None and not decided[0]:
                return None
            buf = self._buffers[trace_id] = []
            self._active.inc()
        return buf

    def begin(self, ctx: RequestTraceContext) -> None:
        """Open a buffer for ``ctx`` (idempotent per trace)."""
        if not self.enabled or ctx is None:
            return
        with self._lock:
            self._open(ctx.trace_id)

    def span(self, ctx: Optional[RequestTraceContext], name: str,
             start_mono: float, dur_s: float, **attrs) -> None:
        """Buffer one hop span (``start_mono`` on ``time.monotonic()``)."""
        if not self.enabled or ctx is None:
            return
        with self._lock:
            buf = self._open(ctx.trace_id)
            if buf is not None:
                buf.append((str(name), float(start_mono),
                            max(0.0, float(dur_s)), attrs))

    def peek(self, ctx: RequestTraceContext) -> List[dict]:
        """The buffered spans of an unfinished trace (a finished one
        answers from the ring)."""
        if ctx is None:
            return []
        with self._lock:
            buf = self._buffers.get(ctx.trace_id)
            if buf is not None:
                return [dict(name=n, start=s, dur_s=d, **a)
                        for n, s, d, a in buf]
            entry = self._ring.get(ctx.trace_id)
            return list(entry["spans"]) if entry else []

    def _reason(self, ctx, error, retries, preempted, slo_violation,
                handoff) -> Optional[str]:
        if error:
            return "error"
        if handoff:
            return "handoff"
        if preempted:
            return "preempt"
        if retries:
            return "retry"
        if slo_violation:
            return "slo"
        if ctx.keep:
            return "forced"
        if _hash01(ctx.trace_id) < self.sample:
            return "sampled"
        return None

    def finish(self, ctx: Optional[RequestTraceContext], *,
               request: Optional[str] = None,
               error: Optional[str] = None, retries: int = 0,
               preempted: bool = False, slo_violation: bool = False,
               handoff: bool = False, e2e_s: Optional[float] = None
               ) -> Tuple[bool, Optional[str]]:
        """One completion point: flush the trace's buffered spans through
        the tail sampler; ``(kept, reason)``.  The first finish of a
        trace decides and counts; a later one (the router's after the
        engine's) reuses the decision and merges its spans into the same
        ring entry."""
        if not self.enabled or ctx is None:
            return False, None
        with self._lock:
            buf = self._buffers.pop(ctx.trace_id, None)
            if buf is not None:
                self._active.inc(-1.0)
            decided = self._decided.get(ctx.trace_id)
            first = decided is None
            if first:
                reason = self._reason(ctx, error, retries, preempted,
                                      slo_violation, handoff)
                decided = (reason is not None, reason)
                self._decided[ctx.trace_id] = decided
                while len(self._decided) > 4 * self.ring_size:
                    self._decided.popitem(last=False)
            kept, reason = decided
            if first:
                if kept:
                    self._sampled.labels(reason=reason).inc()
                else:
                    self._dropped.inc()
            if not kept:
                return False, reason
            ctx.keep = True      # later hops inherit the decision
            spans = self._emit(ctx, buf or [], request)
            entry = self._ring.get(ctx.trace_id)
            if entry is None:
                entry = {"trace": ctx.trace_id, "request": request,
                         "reason": reason, "error": error,
                         "retries": int(retries), "e2e_s": e2e_s,
                         "spans": []}
                self._ring[ctx.trace_id] = entry
                while len(self._ring) > self.ring_size:
                    self._ring.popitem(last=False)
                    self._evicted.inc()
            else:
                entry["request"] = entry["request"] or request
                entry["error"] = entry["error"] or error
                entry["retries"] = max(entry["retries"], int(retries))
                if e2e_s is not None:
                    entry["e2e_s"] = e2e_s
            entry["spans"].extend(spans)
            return True, reason

    def _emit(self, ctx, buf, request) -> List[dict]:
        """Send buffered spans to the process tracer (monotonic ->
        perf_counter here, once) and return their ring dicts (start on
        the wall clock)."""
        from bigdl_tpu_torch import obs

        tracer = obs.get_tracer()
        off_perf = time.perf_counter() - time.monotonic()
        off_wall = time.time() - time.monotonic()
        out = []
        for name, start_mono, dur_s, attrs in buf:
            if tracer.enabled:
                tracer.complete(name, start_mono + off_perf, dur_s,
                                trace=ctx.trace_id, request=request,
                                **attrs)
            out.append(dict(name=name,
                            start=round(start_mono + off_wall, 6),
                            dur_s=round(dur_s, 9), **attrs))
        return out

    def find(self, key: str) -> Optional[dict]:
        """A kept trace by trace id or request id (newest match)."""
        key = str(key)
        with self._lock:
            entry = self._ring.get(key)
            if entry is not None:
                return dict(entry)
            for e in reversed(self._ring.values()):
                if str(e.get("request")) == key:
                    return dict(e)
        return None

    def completed(self) -> List[dict]:
        """Every kept trace in the ring, oldest first."""
        with self._lock:
            return [dict(e) for e in self._ring.values()]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "sample": self.sample,
                    "ring_size": self.ring_size,
                    "open": len(self._buffers),
                    "kept": len(self._ring),
                    "sampled": {
                        r: int(self._sampled.labels(reason=r).value)
                        for r in KEEP_REASONS
                        if self._sampled.labels(reason=r).value},
                    "dropped": int(self._dropped._solo().value)}


class _NullCollector:
    """The disabled collector: no spans, nothing buffered, no metrics."""

    enabled = False
    sample = 0.0

    def new_context(self):
        return RequestTraceContext(uuid.uuid4().hex[:16])

    def begin(self, ctx):
        pass

    def span(self, ctx, name, start_mono, dur_s, **attrs):
        pass

    def peek(self, ctx):
        return []

    def finish(self, ctx, **kw):
        return False, None

    def find(self, key):
        return None

    def completed(self):
        return []

    def stats(self):
        return {"enabled": False, "sample": 0.0}


NULL_COLLECTOR = _NullCollector()

_lock = threading.Lock()
_collector = NULL_COLLECTOR
_collector_key = None
# (the knobs' key, collector): one tuple rebind, read without the lock on
# the fast path of get_collector
_UNSET = object()
_collector_state = (_UNSET, NULL_COLLECTOR)


def get_collector():
    """The process collector, rebuilt when ``BIGDL_TORCH_REQTRACE_SAMPLE``
    or ``BIGDL_TORCH_REQTRACE_RING`` change (or a ``configure`` pin of
    the obs section does); the shared
    :data:`NULL_COLLECTOR` while sampling is off.  While both knobs read
    as at the last call it is two environment lookups and no lock."""
    global _collector, _collector_key, _collector_state
    raw = obs_knob_key("BIGDL_TORCH_REQTRACE_SAMPLE",
                       "BIGDL_TORCH_REQTRACE_RING")
    seen, col = _collector_state
    if raw == seen:
        return col
    from bigdl_tpu_torch.config import ObsConfig

    cfg = ObsConfig.from_env()
    key = (cfg.reqtrace_sample, cfg.reqtrace_ring)
    with _lock:
        if key != _collector_key:
            _collector_key = key
            _collector = (ReqTraceCollector(cfg.reqtrace_sample,
                                            cfg.reqtrace_ring)
                          if cfg.reqtrace_sample > 0.0
                          else NULL_COLLECTOR)
        _collector_state = (raw, _collector)
        return _collector


def reset_collector():
    """Drop the collector; the next accessor rebuilds it from the
    environment (``obs.reset``)."""
    global _collector, _collector_key, _collector_state
    with _lock:
        _collector = NULL_COLLECTOR
        _collector_key = None
        _collector_state = (_UNSET, NULL_COLLECTOR)


__all__ = ["TRACE_HEADER", "KEEP_REASONS", "RequestTraceContext",
           "ReqTraceCollector", "NULL_COLLECTOR", "get_collector",
           "reset_collector"]
