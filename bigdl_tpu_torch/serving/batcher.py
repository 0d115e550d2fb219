"""Request objects and the bounded request queue of the serving tier.

Counterpart of ``bigdl_tpu/serving/batcher.py`` (``ServeRequest``,
``RequestQueue`` at :147).  The JAX package feeds the queue through
the streaming tier's ``BoundedBuffer``; here it is a plain bounded
deque under a ``threading.Condition``, with the same contract: a full
queue blocks the client in ``submit`` (requests are never dropped), and
``take`` waits at most ``timeout`` for the first request, then drains
greedily without blocking.  ``depth()`` stamps the
``bigdl_serve_queue_depth`` gauge, as the JAX queue does.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, List, Optional

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs import names

_ids = itertools.count()


@dataclasses.dataclass
class ServeRequest:
    """One in-flight request (LM decode or classifier forward)."""

    payload: Any                      # prompt token ids, or features
    max_new_tokens: int = 0
    temperature: float = 0.0
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    t_first: Optional[float] = None   # first generated token (TTFT)
    t_done: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    result: Any = None                # the classifier's output row
    # the request-trace context (obs/reqtrace.py) a caller passed, and
    # the caller's request id: both ride a drain's HandoffRecord
    trace: Any = None
    router_id: Optional[str] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def finish(self, error: Optional[str] = None,
               t_done: Optional[float] = None):
        """Done (``error`` None) or failed; ``t_done`` (monotonic) is
        the engine's completion time when it has read the clock already,
        so that ``e2e_s`` is the e2e its trace spans partition."""
        self.error = error
        self.t_done = time.monotonic() if t_done is None else t_done
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> "ServeRequest":
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not done after "
                               f"{timeout:g}s")
        return self

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def e2e_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None \
            else self.t_first - self.t_submit


class RequestQueue:
    """Bounded request ingress: ``submit`` on any number of client
    threads, ``take`` on the engine's step loop."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._depth_gauge = obs.get_registry().gauge(
            names.SERVE_QUEUE_DEPTH,
            "Requests queued ahead of engine admission")

    def depth(self) -> int:
        with self._cond:
            d = len(self._q)
        self._depth_gauge.set(float(d))
        return d

    def submit(self, req: ServeRequest,
               timeout: Optional[float] = None) -> ServeRequest:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._q) >= self.capacity and not self._closed:
                remain = None if deadline is None \
                    else deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    raise TimeoutError(
                        f"request queue full for {timeout:g}s")
                self._cond.wait(timeout=remain)
            if self._closed:
                raise RuntimeError("request queue is closed")
            self._q.append(req)
            self._cond.notify_all()
        return req

    def take(self, max_n: int, timeout: float = 0.0) -> List[ServeRequest]:
        """Up to ``max_n`` queued requests; waits at most ``timeout``
        for the first one, then takes what is there without blocking."""
        deadline = time.monotonic() + max(0.0, timeout)
        out: List[ServeRequest] = []
        with self._cond:
            while not self._q and not self._closed:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._cond.wait(timeout=remain)
            while self._q and len(out) < max_n:
                out.append(self._q.popleft())
            if out:
                self._cond.notify_all()
        return out

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


__all__ = ["ServeRequest", "RequestQueue"]
