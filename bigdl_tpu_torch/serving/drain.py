"""Graceful drain and exactly-once handoff for the serving tier.

Counterpart of ``bigdl_tpu/serving/drain.py``.  Draining an engine must
never lose or duplicate a request:

* :data:`HANDOFF_ERROR` is the ``ServeRequest.error`` a drained (or
  closed) engine finishes an unfinished request with.  A client blocked
  in ``req.wait`` unblocks, sees it, and knows the request was
  checkpointed, not failed: the tokens generated so far are in
  ``req.tokens`` and the refolded prompt (the original prompt plus that
  prefix, the fold the KV-page preemption uses) in ``req.payload``, so
  replaying that prompt elsewhere at temperature 0 continues the decode;
* :class:`HandoffRecord` is that checkpoint, as a JSON-able record
  (``ServingServer`` returns it in a 503 body and from
  ``/admin/drain``);
* :class:`HandoffLedger` is the exactly-once gate: ``claim`` succeeds
  once per request id, ``deliver`` returns False on a second
  completion (a duplicate).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

#: ServeRequest.error of a checkpointed request: "replay me"
HANDOFF_ERROR = "__drain_handoff__"


@dataclasses.dataclass
class HandoffRecord:
    """One checkpointed request, ready to replay on another engine."""

    prompt: List[int]            # original prompt + generated prefix
    max_new_tokens: int          # tokens still owed
    temperature: float = 0.0
    tokens_done: List[int] = dataclasses.field(default_factory=list)
    request_id: Optional[str] = None   # the caller's id, if it gave one
    source: Optional[str] = None       # the engine the checkpoint left
    # the request's X-Bigdl-Trace header, so a replay continues under
    # the same trace id
    trace: Optional[str] = None
    # the weight version the prefix was decoded under: a replay on an
    # engine serving another version would continue on other weights
    weight_version: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HandoffRecord":
        return cls(prompt=[int(t) for t in d["prompt"]],
                   max_new_tokens=int(d["max_new_tokens"]),
                   temperature=float(d.get("temperature", 0.0)),
                   tokens_done=[int(t) for t in
                                d.get("tokens_done") or []],
                   request_id=d.get("request_id"),
                   source=d.get("source"),
                   trace=d.get("trace"),
                   weight_version=d.get("weight_version"))


class HandoffLedger:
    """Exactly-once accounting of replays and deliveries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._claimed: Dict[str, int] = {}    # request id -> claims
        self._delivered: set = set()
        self.duplicates = 0

    def claim(self, request_id: str) -> bool:
        """The right to replay ``request_id``: True once per id; a
        second claimant is refused and stands down."""
        rid = str(request_id)
        with self._lock:
            if rid in self._delivered:
                return False
            n = self._claimed.get(rid, 0)
            self._claimed[rid] = n + 1
            return n == 0

    def release(self, request_id: str) -> None:
        """Undo a claim whose replay could not start, so another path
        may take the request; never after the replay was submitted."""
        with self._lock:
            rid = str(request_id)
            if self._claimed.get(rid, 0) > 0:
                self._claimed[rid] -= 1

    def deliver(self, request_id: str) -> bool:
        """Record the request's one completion; False if the id was
        already delivered (a duplicate, counted)."""
        rid = str(request_id)
        with self._lock:
            if rid in self._delivered:
                self.duplicates += 1
                return False
            self._delivered.add(rid)
            return True

    def delivered(self, request_id: str) -> bool:
        with self._lock:
            return str(request_id) in self._delivered

    def stats(self) -> dict:
        with self._lock:
            return {"claimed": len(self._claimed),
                    "delivered": len(self._delivered),
                    "duplicates": self.duplicates}


def drain_engine(engine, deadline_s: float = 10.0,
                 poll_s: float = 0.005) -> List[HandoffRecord]:
    """Drain one :class:`~bigdl_tpu_torch.serving.LMEngine` in place.

    Admissions stop at once (``engine.draining``: ``submit`` raises a
    RuntimeError, which ``ServingServer`` answers with 503 +
    Retry-After).  In-flight decodes get ``deadline_s`` to finish (the
    caller's thread pumps the engine when no loop drives it); then
    every still-active slot is preempted through the engine's own fold
    (generated tokens -> prompt), and everything left (preempted,
    stashed or still queued) becomes a :class:`HandoffRecord`, its
    request finished with :data:`HANDOFF_ERROR` (a traced request's
    trace ends with a handoff span, kept).  The engine's lock is taken
    through ``engine.locked()``, so a running step loop lets the drain
    in at its next step boundary."""
    engine.draining = True
    deadline = time.monotonic() + max(0.0, float(deadline_s))
    while time.monotonic() < deadline:
        with engine.locked():
            busy = (engine.active_count() or engine._stash
                    or engine.queue.depth() > 0)
        if not busy:
            break
        if engine._thread is None:
            engine.pump(wait_s=poll_s)
        else:
            time.sleep(poll_s)
    handoffs: List[HandoffRecord] = []
    with engine.locked():
        while engine.active_count():
            if engine._preempt_youngest() is None:
                break
        leftovers = list(engine._stash)
        engine._stash.clear()
        while engine.queue.depth() > 0:
            batch = engine.queue.take(engine.max_batch, timeout=0.0)
            if not batch:
                break
            leftovers.extend(batch)
        for req in leftovers:
            ctx = req.trace
            if getattr(req, "_tr_admits", None) is not None:
                # the engine-side trace ends here, kept (a handoff), and
                # before the record serializes the context, so its
                # header carries the keep flag to the replay
                from bigdl_tpu_torch.obs import reqtrace
                from bigdl_tpu_torch.serving import spans

                col = reqtrace.get_collector()
                now = time.monotonic()
                col.span(ctx, spans.SPAN_HANDOFF, now, 0.0,
                         tokens_done=len(req.tokens),
                         owed=int(req.max_new_tokens), side="drain")
                col.finish(ctx, request=str(req.router_id or req.id),
                           handoff=True,
                           e2e_s=max(0.0, now - req.t_submit))
            handoffs.append(HandoffRecord(
                prompt=[int(t) for t in req.payload],
                max_new_tokens=int(req.max_new_tokens),
                temperature=float(req.temperature),
                tokens_done=[int(t) for t in req.tokens],
                request_id=req.router_id,
                trace=ctx.to_header() if ctx is not None else None,
                weight_version=engine.weight_version))
            req.finish(error=HANDOFF_ERROR)
    return handoffs


__all__ = ["HANDOFF_ERROR", "HandoffLedger", "HandoffRecord",
           "drain_engine"]
