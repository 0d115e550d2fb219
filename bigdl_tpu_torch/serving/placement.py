"""Replica placement policy of the serving router.

Counterpart of ``bigdl_tpu/serving/placement.py``: host-side policy
with no I/O and no clock of its own.  The router feeds it
:class:`ReplicaView` snapshots built from the signals every replica
exports (queue depth, KV pages in use, weight version) and an
injectable ``clock``.  Two concerns, in order:

* **session affinity**: a multi-turn conversation's KV prefix lives in
  one replica's paged cache, so ``choose(session=...)`` keeps the
  session on its bound replica while that replica is eligible and the
  binding is inside ``affinity_ttl_s``; a binding to a drained or dead
  replica is dropped and the session rebinds where it lands next;
* **load- and KV-pressure-aware spread**: among eligible replicas the
  lowest ``queue_depth + in_flight + kv_weight * kv_frac`` wins, ties
  by name.  ``kv_frac`` is page-pool occupancy: a nearly full pool
  preempts whatever it admits next.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional


class NoReplicaAvailable(RuntimeError):
    """Every replica is down or draining — the caller must shed."""


@dataclasses.dataclass
class ReplicaView:
    """One replica's placement-relevant state, as the router sees it."""

    name: str
    up: bool = True
    draining: bool = False
    queue_depth: float = 0.0
    in_flight: int = 0          # router-side: placed, not yet completed
    kv_frac: float = 0.0        # pages_in_use / pool size, 0..1
    # host-clock skew past the staleness threshold: its SLO windows
    # and handoff timestamps cannot be trusted, so placement skips it
    stale: bool = False
    # the weight version the replica serves (None: unknown); a
    # version-pinned handoff replay matches on it
    version: Optional[str] = None

    @property
    def eligible(self) -> bool:
        return self.up and not self.draining and not self.stale


class PlacementPolicy:
    """Session-affine, least-loaded placement over replica views."""

    def __init__(self, affinity_ttl_s: float = 300.0,
                 kv_weight: float = 4.0,
                 clock: Callable[[], float] = time.monotonic):
        self.affinity_ttl_s = float(affinity_ttl_s)
        self.kv_weight = float(kv_weight)
        self._clock = clock
        self._lock = threading.Lock()
        # session -> (replica name, binding expiry on self._clock)
        self._bind: Dict[str, tuple] = {}
        self.affinity_hits = 0
        self.rebinds = 0

    # ------------------------------------------------------------ affinity
    def lookup(self, session: Optional[str]) -> Optional[str]:
        """The session's bound replica, or None (no/expired binding)."""
        if not session or self.affinity_ttl_s <= 0:
            return None
        with self._lock:
            bound = self._bind.get(session)
            if bound is None:
                return None
            name, expires = bound
            if self._clock() >= expires:
                del self._bind[session]
                return None
            return name

    def bind(self, session: Optional[str], name: str) -> None:
        if not session or self.affinity_ttl_s <= 0:
            return
        with self._lock:
            prev = self._bind.get(session)
            if prev is not None and prev[0] != name:
                self.rebinds += 1
            self._bind[session] = (name, self._clock()
                                   + self.affinity_ttl_s)

    def unbind_replica(self, name: str) -> List[str]:
        """Drop every session bound to ``name`` (drained or dead — its
        KV prefixes are gone); returns the affected sessions."""
        with self._lock:
            gone = [s for s, (n, _) in self._bind.items() if n == name]
            for s in gone:
                del self._bind[s]
            return gone

    def bindings(self) -> Dict[str, str]:
        with self._lock:
            now = self._clock()
            return {s: n for s, (n, exp) in self._bind.items()
                    if now < exp}

    # ------------------------------------------------------------- scoring
    def score(self, view: ReplicaView) -> float:
        return (float(view.queue_depth) + float(view.in_flight)
                + self.kv_weight * float(view.kv_frac))

    def choose(self, views: Dict[str, ReplicaView],
               session: Optional[str] = None,
               exclude: Optional[set] = None) -> str:
        """Pick a replica for one request.  Affinity wins while the
        bound replica is eligible; otherwise least-loaded (score, then
        name).  ``exclude`` removes replicas already tried by this
        request's retry loop.  Binds/rebinds the session to whatever is
        returned.  Raises :class:`NoReplicaAvailable` when nothing is
        eligible — shedding is the caller's job (it owns the 503)."""
        exclude = exclude or set()
        bound = self.lookup(session)
        if bound is not None and bound not in exclude:
            view = views.get(bound)
            if view is not None and view.eligible:
                with self._lock:
                    self.affinity_hits += 1
                self.bind(session, bound)   # refresh the TTL
                return bound
        candidates = [v for n, v in views.items()
                      if v.eligible and n not in exclude]
        if not candidates:
            raise NoReplicaAvailable(
                f"no eligible replica among {sorted(views)} "
                f"(excluded {sorted(exclude)})")
        best = min(candidates, key=lambda v: (self.score(v), v.name))
        self.bind(session, best.name)
        return best.name

    def stats(self) -> dict:
        with self._lock:
            return {"bindings": len(self._bind),
                    "affinity_hits": self.affinity_hits,
                    "rebinds": self.rebinds}


__all__ = ["NoReplicaAvailable", "PlacementPolicy", "ReplicaView"]
