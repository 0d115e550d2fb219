"""Request-trace identity carried across serving hops.

Counterpart of ``bigdl_tpu/obs/reqtrace.py``: the ``X-Bigdl-Trace``
header and :class:`RequestTraceContext` (:50-98), and the disabled
collector (:323-359).  ``ServingServer`` parses the header of a
``/v1/generate`` call, the engine keeps the context on the request, and
a drain's :class:`~bigdl_tpu_torch.serving.drain.HandoffRecord` carries
it, so a replay elsewhere continues under the same trace id.  The
sampling ``ReqTraceCollector`` (JAX :108) waits for the router slice:
until then :func:`get_collector` is always the null collector, which
records nothing.
"""

from __future__ import annotations

import uuid
from typing import Optional

#: the HTTP propagation header: ``<trace_id>:<parent_span>:<flags>``
TRACE_HEADER = "X-Bigdl-Trace"


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


class _NullCollector:
    """The disabled collector: no spans, nothing buffered."""

    enabled = False
    sample = 0.0

    def new_context(self):
        return RequestTraceContext(uuid.uuid4().hex[:16])

    def begin(self, ctx):
        pass

    def span(self, ctx, name, start_mono, dur_s, **attrs):
        pass

    def finish(self, ctx, **kw):
        return False, None


NULL_COLLECTOR = _NullCollector()


def get_collector():
    """The process collector: the null one until the sampling collector
    is ported."""
    return NULL_COLLECTOR


__all__ = ["TRACE_HEADER", "RequestTraceContext", "NULL_COLLECTOR",
           "get_collector"]
