"""Multi-replica serving router: the fault-tolerant data plane.

Counterpart of ``bigdl_tpu/serving/router.py``.  One stdlib HTTP tier
(:class:`RouterServer`) in front of N :class:`~bigdl_tpu_torch.serving.
LMEngine` replicas, built from four policies:

* **placement** (``serving/placement.py``): session affinity keeps a
  multi-turn KV prefix resident; otherwise least loaded by queue depth
  + router in-flight + KV-page pressure;
* **bounded retries**: a transient replica failure (refused, timed
  out, a full queue's 503) re-places the request on another replica
  after a jittered backoff, while the shared
  :class:`~bigdl_tpu_torch.resilience.retry.RetryBudget` grants a
  token; an empty budget sheds the request with 503 + ``Retry-After``;
* **drain and handoff** (``serving/drain.py``): ``begin_drain`` stops
  placements onto a replica, lets it finish what it can inside the
  deadline, and each checkpointed request's own ``route()`` replays it
  elsewhere once (claim-gated through the :class:`HandoffLedger`); a
  handoff is pinned to the weight version it was decoded under;
* **telemetry**: the ``bigdl_router_*`` families of ``obs/names.py``
  and the request-trace hops of ``serving/spans.py``.

Replicas are duck-typed (``generate`` / ``signals`` / ``drain``):
:class:`EngineReplica` wraps an engine in this process,
:class:`HTTPReplica` a :class:`~bigdl_tpu_torch.serving.ServingServer`.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.config import ObsConfig, RouterConfig
from bigdl_tpu_torch.obs import names, reqtrace
from bigdl_tpu_torch.resilience.retry import RetryBudget, backoff_delay
from bigdl_tpu_torch.serving import spans
from bigdl_tpu_torch.serving.drain import (HANDOFF_ERROR, HandoffLedger,
                                           HandoffRecord)
from bigdl_tpu_torch.serving.placement import (NoReplicaAvailable,
                                               PlacementPolicy, ReplicaView)

log = logging.getLogger("bigdl_tpu_torch.serving")

_rids = itertools.count()


class ReplicaUnavailable(RuntimeError):
    """Transient replica failure — retry elsewhere (budget permitting)."""


class ReplicaDraining(RuntimeError):
    """The replica checkpointed this request mid-drain; ``handoff``
    carries the resume point."""

    def __init__(self, handoff: HandoffRecord):
        super().__init__(f"checkpointed by draining replica "
                         f"{handoff.source}")
        self.handoff = handoff


class RouterShed(RuntimeError):
    """Load shed: retry budget exhausted or no eligible replica.  The
    HTTP tier maps this to 503 + ``Retry-After``; ``budget`` (the
    shared retry budget's stats snapshot, when the router had one)
    rides the 503 body so clients can see *why* they were shed."""

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 budget: Optional[dict] = None):
        super().__init__(reason)
        self.retry_after_s = float(retry_after_s)
        self.budget = budget


def _claim_key(hd: HandoffRecord) -> str:
    """Exactly-once claim key for one handoff *event*: the same record
    surfacing on two recovery paths (per-request retry loop vs the
    drain sweep) builds the same key, while a later re-handoff of the
    same request (longer refolded prompt) builds a fresh one."""
    return f"{hd.request_id}@{hd.source}#{len(hd.prompt)}"


# ---------------------------------------------------------------- replicas
class EngineReplica:
    """In-process replica: one ``LMEngine`` (started, or pumped by the
    caller)."""

    def __init__(self, name: str, engine):
        self.name = str(name)
        self.engine = engine

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, timeout_s: float = 30.0,
                 request_id: Optional[str] = None,
                 trace=None) -> dict:
        try:
            req = self.engine.submit(prompt, max_new_tokens,
                                     temperature=temperature,
                                     timeout=timeout_s, trace=trace)
        except TimeoutError as e:       # queue full past the timeout
            raise ReplicaUnavailable(f"{self.name}: {e}") from e
        except RuntimeError as e:       # draining / closed queue
            raise ReplicaUnavailable(f"{self.name}: {e}") from e
        req.router_id = request_id
        try:
            req.wait(timeout_s)
        except TimeoutError as e:
            raise ReplicaUnavailable(f"{self.name}: {e}") from e
        if req.error == HANDOFF_ERROR:
            ctx = getattr(req, "trace", None)
            raise ReplicaDraining(HandoffRecord(
                prompt=[int(t) for t in req.payload],
                max_new_tokens=int(req.max_new_tokens),
                temperature=float(req.temperature),
                tokens_done=[int(t) for t in req.tokens],
                request_id=request_id, source=self.name,
                trace=ctx.to_header() if ctx is not None else None,
                weight_version=getattr(self.engine, "weight_version",
                                       None)))
        if req.error:
            raise ReplicaUnavailable(f"{self.name}: {req.error}")
        return {"tokens": [int(t) for t in req.tokens],
                "ttft_s": req.ttft_s, "e2e_s": req.e2e_s}

    def signals(self) -> dict:
        eng = self.engine
        total = max(1, eng.cache.num_pages - 1)
        return {"up": True, "draining": bool(eng.draining),
                "queue_depth": float(eng.queue.depth()),
                "kv_frac": eng.cache.pages_in_use() / total,
                "weight_version": getattr(eng, "weight_version", None)}

    def drain(self, deadline_s: float = 10.0) -> List[HandoffRecord]:
        records = self.engine.drain(deadline_s)
        for hd in records:
            hd.source = self.name
        return records

    def undrain(self):
        self.engine.draining = False


class HTTPReplica:
    """Remote replica behind a ``ServingServer`` (``fetch`` is
    injectable: ``fetch(url, body=None, timeout_s=..., headers=None)``
    -> ``(status, json)``)."""

    def __init__(self, name: str, base_url: str, fetch=None):
        self.name = str(name)
        self.base = base_url.rstrip("/")
        if not self.base.startswith("http"):
            self.base = "http://" + self.base
        self._fetch = fetch or self._http_fetch

    def _http_fetch(self, url: str, body: Optional[dict] = None,
                    timeout_s: float = 30.0,
                    headers: Optional[dict] = None):
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json"} if data else {}
        hdrs.update(headers or {})
        req = urllib.request.Request(url, data=data, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001 — a torn error body is data
                payload = {}
            return e.code, payload
        except Exception as e:  # noqa: BLE001 — transport error
            raise ReplicaUnavailable(f"{self.name}: {type(e).__name__}: "
                                     f"{e}") from e

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, timeout_s: float = 30.0,
                 request_id: Optional[str] = None,
                 trace=None) -> dict:
        # the trace context crosses the hop as the X-Bigdl-Trace header;
        # the fetch seam sees a headers kwarg only when there is one
        kw = {"timeout_s": timeout_s}
        if trace is not None:
            kw["headers"] = {reqtrace.TRACE_HEADER: trace.to_header()}
        status, out = self._fetch(
            self.base + "/v1/generate",
            {"prompt": [int(t) for t in prompt],
             "max_new_tokens": int(max_new_tokens),
             "temperature": float(temperature),
             "request_id": request_id},
            **kw)
        if status == 200:
            return {"tokens": [int(t) for t in out["tokens"]],
                    "ttft_s": out.get("ttft_s"),
                    "e2e_s": out.get("e2e_s")}
        if status == 503 and isinstance(out.get("handoff"), dict):
            hd = HandoffRecord.from_dict(out["handoff"])
            hd.request_id, hd.source = request_id, self.name
            raise ReplicaDraining(hd)
        if status in (429, 500, 502, 503, 504):
            raise ReplicaUnavailable(
                f"{self.name}: HTTP {status}: {out.get('error')}")
        raise ValueError(f"{self.name}: HTTP {status}: "
                         f"{out.get('error')}")

    def signals(self) -> dict:
        status, out = self._fetch(self.base + "/stats", timeout_s=2.0)
        if status != 200:
            raise ReplicaUnavailable(f"{self.name}: stats HTTP {status}")
        lm = (out or {}).get("lm") or {}
        total = max(1, int(lm.get("kv_pages_total") or 1))
        return {"up": True, "draining": bool(lm.get("draining")),
                "queue_depth": float(lm.get("queue_depth") or 0.0),
                "kv_frac": float(lm.get("kv_pages_in_use") or 0.0)
                / total,
                "weight_version": lm.get("weight_version")}

    def drain(self, deadline_s: float = 10.0) -> List[HandoffRecord]:
        status, out = self._fetch(self.base + "/admin/drain",
                                  {"deadline_s": float(deadline_s)},
                                  timeout_s=deadline_s + 10.0)
        if status != 200:
            raise ReplicaUnavailable(f"{self.name}: drain HTTP {status}")
        records = [HandoffRecord.from_dict(d)
                   for d in out.get("handoffs") or []]
        for hd in records:
            hd.source = self.name
        return records


# ------------------------------------------------------------------ router
class Router:
    """Placement + budgeted retry + drain/handoff over N replicas."""

    def __init__(self, replicas=None, *,
                 affinity_ttl_s: Optional[float] = None,
                 kv_weight: Optional[float] = None,
                 retry_budget_ratio: Optional[float] = None,
                 retry_budget_burst: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None,
                 backoff_base_s: Optional[float] = None,
                 retry_after_s: Optional[float] = None,
                 clock=time.monotonic, sleep=time.sleep, seed: int = 0):
        cfg = RouterConfig.from_env()
        pick = lambda v, d: d if v is None else v  # noqa: E731
        # a replica whose exported host-clock staleness exceeds the
        # threshold is left out of placement
        self.stale_exclude = bool(cfg.stale_exclude)
        self.stale_after_s = float(ObsConfig.from_env().stale_after_s)
        self.max_retries = int(pick(max_retries, cfg.max_retries))
        self.request_timeout_s = float(
            pick(request_timeout_s, cfg.request_timeout_s))
        self.drain_deadline_s = float(
            pick(drain_deadline_s, cfg.drain_deadline_s))
        self.backoff_base_s = float(
            pick(backoff_base_s, cfg.backoff_base_s))
        self.retry_after_s = float(pick(retry_after_s, cfg.retry_after_s))
        self.placement = PlacementPolicy(
            affinity_ttl_s=float(pick(affinity_ttl_s, cfg.affinity_ttl_s)),
            kv_weight=float(pick(kv_weight, cfg.kv_weight)), clock=clock)
        self.budget = RetryBudget(
            ratio=float(pick(retry_budget_ratio, cfg.retry_budget_ratio)),
            burst=float(pick(retry_budget_burst, cfg.retry_budget_burst)))
        self.ledger = HandoffLedger()
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.replicas: Dict[str, object] = {}
        self._in_flight: Dict[str, int] = {}
        self._down: set = set()
        self._draining: set = set()
        for r in (replicas or []):
            self.add_replica(r)

        reg = obs.get_registry()
        self._req_counter = reg.counter(
            names.ROUTER_REQUESTS_TOTAL,
            "Routed requests by final outcome", labels=("outcome",))
        self._retry_counter = reg.counter(
            names.ROUTER_RETRIES_TOTAL,
            "Budget-gated re-placements after transient replica "
            "failures")
        self._shed_counter = reg.counter(
            names.ROUTER_SHED_TOTAL,
            "Requests shed 503 + Retry-After (budget exhausted or no "
            "eligible replica)")
        self._handoff_counter = reg.counter(
            names.ROUTER_HANDOFFS_TOTAL,
            "Checkpointed decodes replayed off draining replicas")
        self._drain_counter = reg.counter(
            names.ROUTER_DRAINS_TOTAL,
            "Replica drain cycles completed")
        self._affinity_counter = reg.counter(
            names.ROUTER_AFFINITY_HITS_TOTAL,
            "Placements that kept a session on its bound replica")
        self._replica_gauge = reg.gauge(
            names.ROUTER_REPLICAS,
            "Replicas by router-observed state", labels=("state",))
        self._budget_gauge = reg.gauge(
            names.ROUTER_RETRY_BUDGET_TOKENS,
            "Tokens left in the shared retry-budget bucket")
        self._stale_counter = reg.counter(
            names.ROUTER_STALE_EXCLUDED_TOTAL,
            "Placement snapshots that excluded a replica for host-"
            "clock staleness past the fleet threshold")
        self._mismatch_counter = reg.counter(
            names.ROLLOUT_VERSION_MISMATCH_TOTAL,
            "Handoff replays refused on a weight-version mismatch "
            "(re-queued toward a version-exact replica)")

    # -------------------------------------------------------- replica set
    def add_replica(self, replica) -> None:
        with self._lock:
            self.replicas[replica.name] = replica
            self._in_flight.setdefault(replica.name, 0)
            self._down.discard(replica.name)
            self._draining.discard(replica.name)

    def remove_replica(self, name: str) -> List[str]:
        """Drop a replica (death, deprovision).  Returns the sessions
        whose affinity binding was torn up — they rebind on their next
        request."""
        with self._lock:
            self.replicas.pop(name, None)
            self._in_flight.pop(name, None)
            self._down.discard(name)
            self._draining.discard(name)
        return self.placement.unbind_replica(name)

    def _note(self, name: str, delta: int) -> None:
        with self._lock:
            if name in self._in_flight:
                self._in_flight[name] = max(
                    0, self._in_flight[name] + delta)

    def views(self) -> Dict[str, ReplicaView]:
        """One placement snapshot: each replica's exported signals
        merged with the router's own in-flight counts and drain/down
        marks.  A replica whose signals probe fails is scored down
        (and recovers the moment a probe succeeds again)."""
        with self._lock:
            replicas = dict(self.replicas)
            in_flight = dict(self._in_flight)
            draining = set(self._draining)
            down = set(self._down)
        views: Dict[str, ReplicaView] = {}
        for name, replica in replicas.items():
            try:
                sig = replica.signals()
            except Exception:  # noqa: BLE001 — a dead replica is data
                views[name] = ReplicaView(name, up=False)
                with self._lock:
                    self._down.add(name)
                continue
            with self._lock:
                self._down.discard(name)
            stale = (self.stale_exclude and self.stale_after_s > 0
                     and float(sig.get("staleness_s") or 0.0)
                     > self.stale_after_s)
            if stale:
                self._stale_counter.inc()
            views[name] = ReplicaView(
                name, up=bool(sig.get("up", True)) and name not in down,
                draining=bool(sig.get("draining")) or name in draining,
                queue_depth=float(sig.get("queue_depth") or 0.0),
                in_flight=int(in_flight.get(name, 0)),
                kv_frac=float(sig.get("kv_frac") or 0.0),
                stale=stale,
                version=sig.get("weight_version"))
        counts = {"up": 0, "draining": 0, "down": 0, "stale": 0}
        for v in views.values():
            counts["down" if not v.up else
                   "draining" if v.draining else
                   "stale" if v.stale else "up"] += 1
        for state, n in counts.items():
            self._replica_gauge.labels(state=state).set(float(n))
        return views

    # ------------------------------------------------------------ routing
    def _shed(self, rid: str, reason: str, ctx=None):
        self._shed_counter.inc()
        self._req_counter.labels(outcome="shed").inc()
        if ctx is not None:
            reqtrace.get_collector().finish(
                ctx, request=rid, error=f"shed: {reason}")
        raise RouterShed(reason, retry_after_s=self.retry_after_s,
                         budget=self.budget.stats())

    def route(self, prompt, max_new_tokens: int, *,
              temperature: float = 0.0, session: Optional[str] = None,
              request_id: Optional[str] = None, trace=None) -> dict:
        """Route one request to completion.  Returns ``{id, tokens,
        replica, retries, handoffs}``; raises :class:`RouterShed` when
        load must be shed, ValueError on a fatal client error."""
        rid = request_id or f"r{next(_rids)}"
        col = reqtrace.get_collector()
        ctx = trace
        if col.enabled:
            if ctx is None:
                ctx = col.new_context()
            col.begin(ctx)
        else:
            ctx = None
        t_route = time.monotonic()
        self.budget.record_request()
        self._budget_gauge.set(self.budget.tokens())
        prompt_cur = [int(t) for t in prompt]
        owed = int(max_new_tokens)
        prefix: List[int] = []
        tried: set = set()
        retries = 0
        handoffs = 0
        pinned: Optional[str] = None   # weight version a handoff pinned
        affinity0 = self.placement.affinity_hits
        while True:
            t_place = time.monotonic()
            views = self.views()
            try:
                name = self.placement.choose(views, session,
                                             exclude=tried)
            except NoReplicaAvailable as e:
                self._shed(rid, str(e), ctx)
            if pinned is not None:
                view = views.get(name)
                if view is not None and view.version is not None \
                        and view.version != pinned:
                    # the absorber serves a different weight version
                    # than the checkpointed prefix was decoded under —
                    # replaying here would break the bit-equal replay
                    # contract.  Refuse and re-queue toward a
                    # version-exact replica.
                    self._mismatch_counter.inc()
                    tried.add(name)
                    continue
            col.span(ctx, spans.SPAN_PLACEMENT, t_place,
                     time.monotonic() - t_place, replica=name,
                     attempt=retries + handoffs)
            if self.placement.affinity_hits > affinity0:
                affinity0 = self.placement.affinity_hits
                self._affinity_counter.inc()
            with self._lock:
                replica = self.replicas.get(name)
            if replica is None:
                tried.add(name)
                continue
            self._note(name, +1)
            try:
                kw = {} if ctx is None else {"trace": ctx}
                out = replica.generate(
                    prompt_cur, owed, temperature=temperature,
                    timeout_s=self.request_timeout_s, request_id=rid,
                    **kw)
            except ReplicaDraining as e:
                hd = e.handoff
                if not self.ledger.claim(_claim_key(hd)):
                    # another recovery path already replays this
                    # checkpoint — standing down is what keeps the
                    # request landing exactly once
                    self._req_counter.labels(outcome="failed").inc()
                    if ctx is not None:
                        col.finish(ctx, request=rid,
                                   error=f"shed: request {rid} already "
                                         f"replayed elsewhere",
                                   handoff=True)
                    raise RouterShed(
                        f"request {rid} already replayed elsewhere",
                        retry_after_s=self.retry_after_s,
                        budget=self.budget.stats()) from e
                if ctx is not None:
                    # handoffs are exactly what tail sampling must
                    # keep — force the decision before the replay hop
                    ctx.keep = True
                    col.span(ctx, spans.SPAN_HANDOFF,
                             time.monotonic(), 0.0, source=name,
                             tokens_done=len(hd.tokens_done),
                             owed=int(hd.max_new_tokens),
                             side="router")
                prefix.extend(hd.tokens_done)
                prompt_cur = list(hd.prompt)
                owed = int(hd.max_new_tokens)
                pinned = hd.weight_version or pinned
                handoffs += 1
                self._handoff_counter.inc()
                with self._lock:
                    self._draining.add(name)
                self.placement.unbind_replica(name)
                tried = set()       # fresh placement epoch post-handoff
                continue
            except ReplicaUnavailable:
                tried.add(name)
                with self._lock:
                    self._down.add(name)
                if retries >= self.max_retries:
                    self._req_counter.labels(outcome="failed").inc()
                    self._shed(rid, f"request {rid}: "
                                    f"{retries + 1} attempts failed",
                               ctx)
                if not self.budget.try_spend():
                    self._budget_gauge.set(self.budget.tokens())
                    self._shed(rid, "retry budget exhausted — fleet is "
                                    "browning out", ctx)
                retries += 1
                self._retry_counter.inc()
                self._budget_gauge.set(self.budget.tokens())
                t_retry = time.monotonic()
                delay = backoff_delay(
                    retries, base=self.backoff_base_s, cap=1.0,
                    rng=self._rng)
                self._sleep(delay)
                if ctx is not None:
                    # a retried request is an anomaly: keep its trace
                    ctx.keep = True
                    col.span(ctx, spans.SPAN_RETRY, t_retry, delay,
                             replica=name, attempt=retries,
                             budget_tokens=round(
                                 self.budget.tokens(), 2))
                continue
            finally:
                self._note(name, -1)
            tokens = prefix + out["tokens"]
            self.ledger.deliver(rid)
            self._req_counter.labels(outcome="ok").inc()
            resp = {"id": rid, "tokens": tokens, "replica": name,
                    "retries": retries, "handoffs": handoffs,
                    "ttft_s": out.get("ttft_s"),
                    "e2e_s": out.get("e2e_s")}
            if ctx is not None:
                col.span(ctx, spans.SPAN_ROUTE, t_route,
                         time.monotonic() - t_route, replica=name,
                         retries=retries, handoffs=handoffs)
                col.finish(ctx, request=rid, retries=retries,
                           handoff=handoffs > 0,
                           e2e_s=time.monotonic() - t_route)
                resp["trace"] = ctx.trace_id
            return resp

    # -------------------------------------------------------------- drain
    def begin_drain(self, name: str,
                    deadline_s: Optional[float] = None) -> dict:
        """Drain one replica: placements stop immediately, the replica
        finishes what it can inside the deadline, and checkpointed
        router-owned requests replay through their own waiting route()
        calls (claim-gated).  Orphan checkpoints (submitted to the
        replica directly, not through this router) are returned for
        the operator — the router has no client to answer for them."""
        with self._lock:
            replica = self.replicas.get(name)
            if replica is None:
                raise KeyError(f"unknown replica {name!r}")
            self._draining.add(name)
        sessions = self.placement.unbind_replica(name)
        records = replica.drain(deadline_s if deadline_s is not None
                                else self.drain_deadline_s)
        self._drain_counter.inc()
        owned = [hd for hd in records if hd.request_id is not None]
        orphans = [hd.to_dict() for hd in records
                   if hd.request_id is None]
        return {"replica": name, "handoffs": len(records),
                "router_owned": len(owned), "orphans": orphans,
                "sessions_unbound": len(sessions)}

    def undrain(self, name: str) -> None:
        with self._lock:
            replica = self.replicas.get(name)
            self._draining.discard(name)
        if replica is not None and hasattr(replica, "undrain"):
            replica.undrain()

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        views = self.views()
        return {
            "replicas": {n: _view_dict(v)
                         for n, v in sorted(views.items())},
            "budget": self.budget.stats(),
            "placement": self.placement.stats(),
            "ledger": self.ledger.stats(),
        }


def _view_dict(v: ReplicaView) -> dict:
    return {"up": v.up, "draining": v.draining,
            "queue_depth": v.queue_depth, "in_flight": v.in_flight,
            "kv_frac": round(v.kv_frac, 4), "stale": v.stale,
            "weight_version": v.version}


# ------------------------------------------------------------- HTTP front
class RouterServer:
    """stdlib HTTP front end of a :class:`Router`.

    * ``POST /v1/generate`` ``{"prompt": [...], "max_new_tokens": N,
      "temperature": t, "session": "abc"}`` — routed, retried,
      handed off as needed; sheds with 503 + ``Retry-After``;
    * ``POST /admin/drain`` ``{"replica": name, "deadline_s": s}``;
    * ``GET /stats`` / ``GET /healthz``.
    """

    def __init__(self, router: Router, *, port: Optional[int] = None,
                 host: str = "127.0.0.1"):
        cfg = RouterConfig.from_env()
        if port is None:
            port = cfg.port if cfg.port is not None else 0
        self.router = router
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                log.debug("router: " + fmt, *args)

            def _send(self, obj, code=200, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    views = outer.router.views()
                    return self._send({
                        "status": "ok",
                        "replicas": {n: ("draining" if v.draining
                                         else "stale" if v.stale
                                         else "up" if v.up else "down")
                                     for n, v in views.items()},
                        "weight_versions": {n: v.version
                                            for n, v in views.items()}})
                if self.path == "/stats":
                    return self._send(outer.router.stats())
                return self._send({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0) or 0)
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/v1/generate":
                        # a traced upstream hands us its context in the
                        # X-Bigdl-Trace header; otherwise route() mints
                        # one itself when the collector is on
                        ctx = None
                        if reqtrace.get_collector().enabled:
                            ctx = reqtrace.RequestTraceContext \
                                .from_header(self.headers.get(
                                    reqtrace.TRACE_HEADER))
                        out = outer.router.route(
                            payload["prompt"],
                            int(payload.get("max_new_tokens", 16)),
                            temperature=float(
                                payload.get("temperature", 0.0)),
                            session=payload.get("session"),
                            trace=ctx)
                        return self._send(out)
                    if self.path == "/admin/drain":
                        return self._send(outer.router.begin_drain(
                            payload["replica"],
                            deadline_s=payload.get("deadline_s")))
                    return self._send({"error": "not found"}, 404)
                except RouterShed as e:
                    # the shed body carries the retry-budget snapshot
                    # so a shed client can tell "replica brownout"
                    # from "I personally retried too much"
                    body = {"error": str(e),
                            "retry_after_s": e.retry_after_s}
                    if e.budget is not None:
                        body["retry_budget"] = e.budget
                    return self._send(
                        body, 503,
                        headers={"Retry-After":
                                 f"{max(1, round(e.retry_after_s))}"})
                except KeyError as e:
                    return self._send(
                        {"error": f"missing field {e}"}, 400)
                except (TypeError, ValueError) as e:
                    return self._send(
                        {"error": f"{type(e).__name__}: {e}"}, 400)
                except Exception as e:  # noqa: BLE001 — router bug
                    return self._send(
                        {"error": f"{type(e).__name__}: {e}"}, 500)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="bigdl-torch-router-http", daemon=True)
        self._thread.start()
        log.info("serving router on %s:%d over %d replica(s)",
                 host, self.port, len(router.replicas))

    def url(self, path: str = "/stats") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


__all__ = ["EngineReplica", "HTTPReplica", "ReplicaDraining",
           "ReplicaUnavailable", "Router", "RouterServer", "RouterShed"]
