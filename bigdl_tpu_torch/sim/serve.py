"""Serving data-plane chaos simulator — real router policies, synthetic
replicas, virtual clock.

The fleet simulator (sim/runner.py) proved the *control* plane at
scale; this module does the same for the *data* plane the router tier
(serving/router.py) owns.  A :class:`SimServeReplica` models one
serving replica's request flow — admission queue, bounded decode
slots, per-request service time, a paged-KV pool whose occupancy is
the ``kv_frac`` placement signal — while the REAL policy objects make
every decision, exactly as they do behind HTTP:

* the real :class:`~bigdl_tpu_torch.serving.placement.PlacementPolicy`
  places every request (session affinity + least-loaded by queue
  depth / in-flight / KV pressure);
* the real :class:`~bigdl_tpu_torch.resilience.retry.RetryBudget` gates
  every retry — budget exhausted means shed, not queue;
* the real :class:`~bigdl_tpu_torch.serving.drain.HandoffLedger` claim-gates
  every checkpoint replay and deduplicates every delivery.

Three builtin chaos scenarios (:data:`SERVE_SCENARIOS`, all at 8
replicas):

* ``preemption_storm`` — half the fleet is preempted mid-run over a
  shared KV pool; their dumped queues are claim-gated handoff replays
  the survivors absorb.  The SLO-burn alert may fire once for the
  storm and must resolve after recovery — no flapping — and not one
  request is lost or duplicated;
* ``brownout`` — one replica turns 40x slow without dying; requests
  stuck on it time out and re-place elsewhere, and the shared retry
  budget must cap backend amplification at the configured factor
  (attempts/requests <= 1 + ratio + slack) while late completions
  from the zombie are discarded, never double-answered;
* ``drain_wave`` — replicas drain under a diurnal wave;
  checkpoint-and-replay must conserve every request: zero dropped,
  zero duplicated, zero shed across the full drain/handoff cycle;
* ``weight_rollout`` — the live-weight-rollout control loop (the REAL
  :class:`~bigdl_tpu_torch.serving.rollout.CanaryController` driving sim
  replicas): a good version canaries and promotes cleanly; a bad
  version (injected latency + divergent logits) triggers exactly one
  hysteresis-gated rollback whose canary drains replay everything; a
  corrupt-mid-publish checkpoint is rejected by the verify gate and
  reaches zero replicas.  Invariants: ``rollback_exactly_once``,
  ``no_version_skew_after_settle``, ``corrupt_never_loaded``,
  ``zero_dropped_requests``.

:func:`run_serve_scenario` runs one scenario tick by tick and hands
the observation bundle to the serve invariants
(:func:`bigdl_tpu_torch.sim.invariants.check_serve_scenario`).
``python -m bigdl_tpu_torch.sim --serve`` runs the four.

Counterpart of ``bigdl_tpu/sim/serve.py``: the same replicas, scenarios,
loop and invariants over the port's ``serving`` and ``resilience``
policy objects, so both packages reach the same counts.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Dict, List, Optional

from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.resilience.retry import RetryBudget, backoff_delay
from bigdl_tpu_torch.serving import spans
from bigdl_tpu_torch.serving.drain import HandoffLedger
from bigdl_tpu_torch.serving.placement import (NoReplicaAvailable,
                                         PlacementPolicy, ReplicaView)
from bigdl_tpu_torch.sim.clock import VirtualClock
from bigdl_tpu_torch.sim.invariants import InvariantResult, check_serve_scenario


# ----------------------------------------------------------- sim replica
class _SimJob:
    """One admitted request inside a sim replica."""

    __slots__ = ("rid", "remaining_s")

    def __init__(self, rid: str, remaining_s: float):
        self.rid = rid
        self.remaining_s = float(remaining_s)


class SimServeReplica:
    """Request-flow model of one serving replica.

    Bounded decode slots drain a bounded admission queue at
    ``service_s`` virtual seconds per request (scaled by
    ``slow_factor`` — a brownout replica still works, just slowly);
    each active request holds ``pages_per_req`` pages of the
    ``kv_pages`` pool, so ``signals()`` exports the same
    queue-depth / KV-pressure shape the real engine's ``stats()``
    does.  ``preempt()`` models losing the host: everything in flight
    is dumped as (rid, remaining) checkpoints for the router to
    replay; ``drain()`` models the graceful path — same checkpoints,
    but the replica stays reachable and refuses admissions."""

    def __init__(self, name: str, *, slots: int = 4,
                 max_queue: int = 128, kv_pages: int = 64,
                 pages_per_req: int = 4):
        self.name = str(name)
        self.slots = int(slots)
        self.max_queue = int(max_queue)
        self.kv_pages = int(kv_pages)
        self.pages_per_req = int(pages_per_req)
        self.up = True
        self.draining = False
        self.slow_factor = 1.0
        self.version = "v0"     # weight version served (rollout tier)
        self.queue: List[_SimJob] = []
        self.active: List[_SimJob] = []

    # -- router-facing surface (the shape EngineReplica exports) --------
    def admit(self, rid: str, service_s: float) -> bool:
        if not self.up or self.draining:
            return False
        if len(self.queue) >= self.max_queue:
            return False
        self.queue.append(_SimJob(rid, service_s))
        return True

    def signals(self) -> dict:
        if not self.up:
            raise RuntimeError(f"{self.name}: connection refused")
        return {"up": True, "draining": self.draining,
                "queue_depth": float(len(self.queue)),
                "kv_frac": min(1.0, len(self.active)
                               * self.pages_per_req / self.kv_pages)}

    def backlog(self) -> int:
        return len(self.queue) + len(self.active)

    # -- physics ---------------------------------------------------------
    def tick(self, dt: float) -> List[str]:
        """Advance ``dt`` virtual seconds; returns completed rids.

        Each of the ``slots`` decode lanes gets ``dt`` seconds of
        work (scaled by ``slow_factor``) and pulls the next queued
        job the moment its current one finishes — so throughput is
        ``slots / service_s`` whenever there is work, independent of
        the tick quantum."""
        if not self.up:
            return []
        done: List[str] = []
        rate = 1.0 / max(1.0, self.slow_factor)
        lanes = list(self.active)
        self.active = []
        for lane in range(self.slots):
            t_avail = dt * rate
            job = lanes[lane] if lane < len(lanes) else None
            while t_avail > 1e-12:
                if job is None:
                    if not self.queue:
                        break
                    job = self.queue.pop(0)
                spent = min(t_avail, job.remaining_s)
                job.remaining_s -= spent
                t_avail -= spent
                if job.remaining_s <= 1e-9:
                    done.append(job.rid)
                    job = None
            if job is not None:
                self.active.append(job)
        return done

    # -- chaos -----------------------------------------------------------
    def preempt(self) -> List[tuple]:
        """The host is gone: dump every in-flight/queued request as a
        (rid, remaining_s) checkpoint and go down."""
        dumped = [(j.rid, j.remaining_s) for j in self.active + self.queue]
        self.active, self.queue = [], []
        self.up = False
        return dumped

    def recover(self):
        self.up = True
        self.draining = False
        self.slow_factor = 1.0

    def drain(self) -> List[tuple]:
        """Graceful drain: stop admissions and checkpoint everything —
        active jobs keep their progress (remaining < full service), the
        exactly-once replay must not lose or duplicate any of it."""
        self.draining = True
        dumped = [(j.rid, j.remaining_s) for j in self.active + self.queue]
        self.active, self.queue = [], []
        return dumped

    def undrain(self):
        self.draining = False


# -------------------------------------------------------------- scenario
@dataclasses.dataclass
class ServeScenario:
    """One declarative serving chaos scenario."""

    name: str
    duration_s: float
    tick_s: float = 0.5
    replicas: int = 8
    slots: int = 4
    service_s: float = 0.2          # mean per-request decode time
    service_jitter: float = 0.2     # +- fraction of service_s
    arrival_rps: float = 40.0
    wave_amp_rps: float = 0.0       # diurnal modulation on top
    wave_period_s: float = 120.0
    arrival_stop_s: Optional[float] = None   # default duration - 30
    session_frac: float = 0.25      # share of requests with a session
    sessions: int = 16
    request_timeout_s: float = 30.0
    max_retries: int = 3
    budget_ratio: float = 0.2
    budget_burst: float = 20.0
    backoff_base_s: float = 0.05
    affinity_ttl_s: float = 300.0
    kv_weight: float = 4.0
    slo_fire_backlog: float = 1.5   # x total slots -> alert fires
    slo_resolve_backlog: float = 0.8
    # rollout tier (active when publish_* events appear): canary
    # evaluation cadence, the incumbent everyone starts on, and the
    # damage a "bad" version injects — extra per-request latency on
    # its canaries plus a divergent pinned-prompt replay signal
    rollout_eval_s: float = 5.0
    incumbent_version: str = "v0"
    bad_slow_factor: float = 6.0
    bad_divergence: float = 0.5
    events: List[dict] = dataclasses.field(default_factory=list)
    expect: dict = dataclasses.field(default_factory=dict)

    def n_ticks(self) -> int:
        return max(1, int(round(self.duration_s / self.tick_s)))


#: the builtin serving chaos matrix (see the module docstring)
SERVE_SCENARIOS: Dict[str, dict] = {
    "preemption_storm": dict(
        name="preemption_storm", duration_s=220.0, replicas=8,
        service_s=0.25, arrival_rps=100.0, arrival_stop_s=180.0,
        budget_burst=50.0,
        events=[
            # half the fleet preempted at once: the survivors' 64 rps
            # against 100 rps offered load saturates their queues —
            # dumped work is claim-gated replay, overflow is explicit
            # budget-gated shedding, and the SLO-burn alert gets ONE
            # episode that must resolve after recovery
            {"t": 60.0, "kind": "preempt",
             "replicas": ["r0", "r1", "r2", "r3"]},
            {"t": 100.0, "kind": "recover",
             "replicas": ["r0", "r1", "r2", "r3"]},
        ],
        expect={"max_lost": 0, "max_duplicates": 0,
                "min_handoff_replays": 1, "min_retries": 10,
                "max_slo_flaps": 1, "slo_resolved": True,
                "amplification_slack": 0.1}),
    "brownout": dict(
        name="brownout", duration_s=240.0, replicas=8,
        arrival_rps=50.0, arrival_stop_s=200.0,
        request_timeout_s=5.0,
        events=[
            {"t": 40.0, "kind": "slow", "replicas": ["r4"],
             "factor": 40.0},
            {"t": 160.0, "kind": "recover", "replicas": ["r4"]},
        ],
        expect={"max_lost": 0, "max_duplicates": 0, "min_retries": 5,
                "amplification_slack": 0.1, "max_slo_flaps": 1,
                "slo_resolved": True}),
    "drain_wave": dict(
        name="drain_wave", duration_s=260.0, replicas=8,
        service_s=0.25, arrival_rps=40.0, wave_amp_rps=25.0,
        wave_period_s=120.0, arrival_stop_s=210.0,
        events=[
            # drains land at the wave peaks (t=30, t=150): the drained
            # replicas are holding real work to checkpoint
            {"t": 28.0, "kind": "drain", "replicas": ["r2"]},
            {"t": 32.0, "kind": "drain", "replicas": ["r5"]},
            {"t": 100.0, "kind": "undrain", "replicas": ["r2", "r5"]},
            {"t": 152.0, "kind": "drain", "replicas": ["r6"]},
            {"t": 200.0, "kind": "undrain", "replicas": ["r6"]},
        ],
        expect={"max_lost": 0, "max_duplicates": 0, "max_shed": 0,
                "max_late_discarded": 0, "min_handoff_replays": 1,
                "min_drains": 3, "max_slo_flaps": 1,
                "amplification_slack": 0.1}),
    "weight_rollout": dict(
        name="weight_rollout", duration_s=200.0, replicas=8,
        arrival_rps=40.0, arrival_stop_s=170.0,
        events=[
            # a good version canaries on the fraction, holds clean for
            # hold_evals rounds, and promotes fleet-wide
            {"t": 30.0, "kind": "publish_good", "version": "v1"},
            # a bad version (6x latency + 0.5 token divergence on its
            # canaries) must trigger EXACTLY one rollback — hysteresis,
            # not flapping — and the canary drains replay everything
            {"t": 80.0, "kind": "publish_bad", "version": "v2"},
            # a corrupt-mid-publish checkpoint is refused by the
            # verify-before-swap gate and reaches zero replicas
            {"t": 140.0, "kind": "publish_corrupt", "version": "v3"},
        ],
        expect={"max_lost": 0, "max_duplicates": 0, "max_shed": 0,
                "min_handoff_replays": 1, "rollbacks": 1,
                "settle_version": "v1", "promotions": ["v1"],
                "min_corrupt_rejected": 1, "max_slo_flaps": 1,
                "amplification_slack": 0.1}),
}


def load_serve_scenario(spec, replicas: Optional[int] = None,
                        time_compression: float = 1.0) -> ServeScenario:
    """Builtin name, JSON string, or dict -> validated ServeScenario.

    The builtin ``expect`` blocks are calibrated at their declared
    replica count and offered load (the storm must saturate the
    survivors for ``min_retries`` to mean anything) — the ``replicas``
    override is for custom scenario specs, which carry their own
    expectations."""
    if isinstance(spec, ServeScenario):
        sc = spec
    else:
        if isinstance(spec, str):
            d = (SERVE_SCENARIOS.get(spec)
                 or (json.loads(spec) if spec.lstrip().startswith("{")
                     else None))
            if d is None:
                raise ValueError(
                    f"unknown serve scenario {spec!r} (builtins: "
                    f"{sorted(SERVE_SCENARIOS)})")
        elif isinstance(spec, dict):
            d = spec
        else:
            raise TypeError(f"scenario spec {type(spec).__name__}")
        sc = ServeScenario(**d)
    if replicas is not None:
        sc = dataclasses.replace(sc, replicas=int(replicas))
    c = max(1.0, float(time_compression))
    if c > 1.0:
        sc = dataclasses.replace(
            sc, duration_s=sc.duration_s / c,
            wave_period_s=sc.wave_period_s / c,
            arrival_stop_s=(None if sc.arrival_stop_s is None
                            else sc.arrival_stop_s / c),
            events=[dict(ev, t=ev["t"] / c) for ev in sc.events])
    if sc.replicas < 2:
        raise ValueError("a router scenario needs >= 2 replicas")
    for ev in sc.events:
        if ev["kind"] not in ("preempt", "recover", "slow", "drain",
                              "undrain", "publish_good", "publish_bad",
                              "publish_corrupt"):
            raise ValueError(f"unknown event kind {ev['kind']!r}")
        if ev["kind"].startswith("publish") and not ev.get("version"):
            raise ValueError(f"publish event at t={ev['t']} needs a "
                             "version")
        if not 0 <= float(ev["t"]) <= sc.duration_s:
            raise ValueError(f"event at t={ev['t']} outside the "
                             f"{sc.duration_s:g}s scenario")
    return sc


# ---------------------------------------------------------------- result
@dataclasses.dataclass
class ServeScenarioResult:
    """One serve scenario's outcome: counters + invariant verdicts."""

    name: str
    ok: bool
    replicas: int
    ticks: int
    duration_s: float
    wall_s: float
    requests: int
    completed: int
    shed: int
    lost: int
    duplicates: int
    retries: int
    backend_attempts: int
    handoff_replays: int
    drains: int
    late_discarded: int
    amplification: float
    affinity_hits: int
    slo_flaps: int
    slo_firing_at_end: bool
    p50_latency_s: Optional[float]
    p99_latency_s: Optional[float]
    budget: dict
    invariants: List[InvariantResult]
    # buffered request traces of the requests that broke an invariant
    # (lost / duplicated), dumped when tracing is on — the postmortem
    # is IN the verdict, not a separate archaeology dig
    offending_traces: List[dict] = dataclasses.field(
        default_factory=list)
    # rollout observations (versions at end, rollback/promotion
    # episodes, corrupt-publish accounting) when the scenario drove a
    # CanaryController; None otherwise
    rollout: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["invariants"] = [dataclasses.asdict(r)
                           for r in self.invariants]
        return d

    def summary(self) -> str:
        inv = ", ".join(f"{r.name}={'ok' if r.ok else 'FAIL'}"
                        for r in self.invariants)
        return (f"serve scenario {self.name}: "
                f"{'PASS' if self.ok else 'FAIL'} "
                f"({self.replicas} replicas, {self.requests} requests, "
                f"{self.completed} completed / {self.shed} shed / "
                f"{self.lost} lost / {self.duplicates} dup, "
                f"{self.retries} retries, {self.handoff_replays} "
                f"replays, amp {self.amplification:.3f}, "
                f"{self.wall_s:.1f}s wall) [{inv}]")


class _ClientReq:
    """Router-side state of one client request in the sim."""

    __slots__ = ("rid", "session", "arrival_t", "attempts", "tried",
                 "ready_t", "remaining_s", "replayed")

    def __init__(self, rid, session, arrival_t, remaining_s):
        self.rid = rid
        self.session = session
        self.arrival_t = float(arrival_t)
        self.attempts = 0
        self.tried: set = set()
        self.ready_t = float(arrival_t)
        self.remaining_s = float(remaining_s)
        self.replayed = 0


# ------------------------------------------------------------------ loop
def run_serve_scenario(spec, replicas: Optional[int] = None,
                       seed: int = 0,
                       time_compression: float = 1.0,
                       max_drainout_ticks: int = 4000
                       ) -> ServeScenarioResult:
    """Run one serving chaos scenario on the virtual clock.

    The loop is the router's decision procedure, one virtual tick at a
    time, with the REAL policy objects making every call: placement by
    :class:`PlacementPolicy`, every retry spending the shared
    :class:`RetryBudget`, every checkpoint replay claim-gated and
    every delivery deduplicated through the :class:`HandoffLedger`.
    After arrivals stop the loop drains out until every request is
    answered (or ``max_drainout_ticks`` passes — anything still
    unanswered then is *lost*, which the conservation invariant pins
    at zero)."""
    sc = load_serve_scenario(spec, replicas=replicas,
                             time_compression=time_compression)
    rng = random.Random(int(seed))
    clock = VirtualClock()
    # request tracing (obs/reqtrace.py): span starts are VIRTUAL-clock
    # stamps here — the value of a sim trace is its hop *sequence and
    # durations* for invariant postmortems, not wall alignment
    col = reqtrace.get_collector()
    ctxs: Dict[str, object] = {}         # rid -> RequestTraceContext
    placement = PlacementPolicy(affinity_ttl_s=sc.affinity_ttl_s,
                                kv_weight=sc.kv_weight, clock=clock)
    budget = RetryBudget(ratio=sc.budget_ratio, burst=sc.budget_burst)
    ledger = HandoffLedger()
    fleet = {f"r{i}": SimServeReplica(f"r{i}", slots=sc.slots)
             for i in range(sc.replicas)}

    pending: List[_ClientReq] = []       # waiting for (re)placement
    live: Dict[str, _ClientReq] = {}     # rid -> request state
    outstanding: Dict[str, tuple] = {}   # rid -> (replica, deadline_t)
    answers: Dict[str, int] = {}         # rid -> times answered
    latencies: List[float] = []
    counts = {"requests": 0, "completed": 0, "shed": 0, "retries": 0,
              "backend_attempts": 0, "handoff_replays": 0, "drains": 0,
              "late_discarded": 0}
    slo = {"firing": False, "flaps": 0}
    total_slots = sc.replicas * sc.slots
    arrival_stop = (sc.arrival_stop_s if sc.arrival_stop_s is not None
                    else max(0.0, sc.duration_s - 30.0))
    events = sorted(sc.events, key=lambda ev: ev["t"])
    next_event = 0
    acc = 0.0
    rid_seq = 0

    # -- rollout tier: the REAL CanaryController over sim callables ----
    controller = None
    rollout = {"bad": set(), "corrupt_rejected": 0, "corrupt_loaded": 0,
               "refused_offers": 0, "next_eval": 0.0, "t": 0.0}
    if any(ev["kind"].startswith("publish") for ev in sc.events):
        from bigdl_tpu_torch.serving.rollout import (SLO_BURN_ALERT,
                                               CanaryController)

        for rep in fleet.values():
            rep.version = sc.incumbent_version

        def _apply_version(name: str, version: str):
            # the harness's set_version: a sim hot-swap.  A bad version
            # manifests as injected per-request latency (its divergence
            # rides the probe below)
            rep = fleet[name]
            rep.version = version
            rep.slow_factor = (sc.bad_slow_factor
                               if version in rollout["bad"] else 1.0)

        def _divergence() -> float:
            # pinned-prompt replay signal: a bad candidate's canaries
            # produce divergent tokens, a good one's are bit-equal
            return (sc.bad_divergence
                    if controller.candidate in rollout["bad"] else 0.0)

        def _alerts():
            return [SLO_BURN_ALERT] if slo["firing"] else []

        def _drain_cb(name: str):
            counts["drains"] += 1
            for rid, rem in fleet[name].drain():
                outstanding.pop(rid, None)
                replay(rid, rem, name, rollout["t"])
            placement.unbind_replica(name)

        def _undrain_cb(name: str):
            fleet[name].undrain()

        controller = CanaryController(
            sorted(fleet), set_version=_apply_version,
            incumbent=sc.incumbent_version,
            measure_divergence=_divergence, alerts=_alerts,
            drain=_drain_cb, undrain=_undrain_cb, clock=clock)

    def views() -> Dict[str, ReplicaView]:
        out = {}
        in_flight: Dict[str, int] = {}
        for rid, (name, _dl) in outstanding.items():
            in_flight[name] = in_flight.get(name, 0) + 1
        for name, rep in fleet.items():
            try:
                sig = rep.signals()
            except RuntimeError:
                out[name] = ReplicaView(name, up=False)
                continue
            out[name] = ReplicaView(
                name, up=True, draining=sig["draining"],
                queue_depth=sig["queue_depth"],
                in_flight=in_flight.get(name, 0),
                kv_frac=sig["kv_frac"])
        return out

    def answer(req: _ClientReq, t: float):
        answers[req.rid] = answers.get(req.rid, 0) + 1
        live.pop(req.rid, None)
        c = ctxs.pop(req.rid, None)
        if c is not None:
            e2e = max(0.0, t - req.arrival_t)
            col.span(c, spans.SPAN_ROUTE, req.arrival_t, e2e,
                     retries=req.attempts, replays=req.replayed)
            col.finish(c, request=req.rid, retries=req.attempts,
                       handoff=req.replayed > 0, e2e_s=e2e)

    def shed(req: _ClientReq, t: float):
        counts["shed"] += 1
        c = ctxs.pop(req.rid, None)
        if c is not None:
            col.finish(c, request=req.rid, error="shed",
                       retries=req.attempts,
                       e2e_s=max(0.0, t - req.arrival_t))
        answer(req, t)

    def fail_attempt(req: _ClientReq, t: float):
        """One placement/attempt failed: budget-gated retry or shed."""
        if req.attempts >= sc.max_retries:
            shed(req, t)
            return
        if not budget.try_spend():
            shed(req, t)
            return
        counts["retries"] += 1
        req.attempts += 1
        delay = backoff_delay(req.attempts, base=sc.backoff_base_s,
                              cap=1.0, rng=rng)
        col.span(ctxs.get(req.rid), spans.SPAN_RETRY, t, delay,
                 attempt=req.attempts,
                 budget_tokens=round(budget.tokens(), 2))
        req.ready_t = t + delay
        pending.append(req)

    def replay(rid: str, remaining_s: float, source: str, t: float):
        """Claim-gated handoff replay — progress preserved, exactly
        once per checkpoint (the sim analog of the engine's bit-exact
        refolded-prompt resume)."""
        key = f"{rid}@{source}#{remaining_s:.6f}"
        if not ledger.claim(key):
            return
        req = live.get(rid)
        if req is None:     # already answered (late checkpoint)
            return
        counts["handoff_replays"] += 1
        col.span(ctxs.get(rid), spans.SPAN_HANDOFF, t, 0.0,
                 source=source, remaining_s=round(remaining_s, 6))
        req.remaining_s = remaining_s
        req.replayed += 1
        req.tried = set()
        req.ready_t = t
        pending.append(req)

    def step(t: float, dt: float, arrivals: bool):
        nonlocal acc, rid_seq, next_event
        rollout["t"] = t
        # 1. chaos events reach their virtual time
        while next_event < len(events) and events[next_event]["t"] <= t:
            ev = events[next_event]
            next_event += 1
            if ev["kind"].startswith("publish"):
                version = str(ev["version"])
                if ev["kind"] == "publish_bad":
                    rollout["bad"].add(version)
                if ev["kind"] == "publish_corrupt":
                    # the watcher's verify-before-swap gate: a torn /
                    # corrupt publish is counted and rejected before
                    # any replica sees it (the real file-level gate is
                    # exercised by the rollout tests —
                    # the sim pins the ORDERING: reject precedes offer)
                    rollout["corrupt_rejected"] += 1
                    continue
                if not controller.offer(version, now=t):
                    rollout["refused_offers"] += 1
                continue
            for name in ev["replicas"]:
                rep = fleet[name]
                if ev["kind"] == "preempt":
                    for rid, rem in rep.preempt():
                        outstanding.pop(rid, None)
                        replay(rid, rem, name, t)
                    placement.unbind_replica(name)
                elif ev["kind"] == "drain":
                    counts["drains"] += 1
                    for rid, rem in rep.drain():
                        outstanding.pop(rid, None)
                        replay(rid, rem, name, t)
                    placement.unbind_replica(name)
                elif ev["kind"] == "slow":
                    rep.slow_factor = float(ev.get("factor", 8.0))
                elif ev["kind"] == "recover":
                    rep.recover()
                elif ev["kind"] == "undrain":
                    rep.undrain()
        # 2. client arrivals (deterministic rate accumulator)
        if arrivals:
            import math

            rate = sc.arrival_rps + sc.wave_amp_rps * math.sin(
                2.0 * math.pi * t / sc.wave_period_s)
            acc += max(0.0, rate) * dt
            while acc >= 1.0:
                acc -= 1.0
                rid = f"q{rid_seq}"
                rid_seq += 1
                session = (f"s{rng.randrange(sc.sessions)}"
                           if rng.random() < sc.session_frac else None)
                service = sc.service_s * (
                    1.0 + sc.service_jitter * (2.0 * rng.random() - 1.0))
                req = _ClientReq(rid, session, t, service)
                live[rid] = req
                counts["requests"] += 1
                budget.record_request()
                if col.enabled:
                    c = col.new_context()
                    col.begin(c)
                    ctxs[rid] = c
                pending.append(req)
        # 3. placement pass over everything due
        due = [r for r in pending if r.ready_t <= t]
        for req in due:
            pending.remove(req)
            snapshot = views()
            try:
                name = placement.choose(snapshot, req.session,
                                        exclude=req.tried)
            except NoReplicaAvailable:
                fail_attempt(req, t)
                continue
            col.span(ctxs.get(req.rid), spans.SPAN_PLACEMENT, t, 0.0,
                     replica=name, attempt=req.attempts)
            if fleet[name].admit(req.rid, req.remaining_s):
                counts["backend_attempts"] += 1
                outstanding[req.rid] = (name, t + sc.request_timeout_s)
            else:
                req.tried.add(name)
                fail_attempt(req, t)
        # 4. replica physics + deliveries (ledger-deduplicated)
        for name, rep in fleet.items():
            for rid in rep.tick(dt):
                outstanding.pop(rid, None)
                if not ledger.deliver(rid):
                    counts["late_discarded"] += 1
                    continue
                req = live.get(rid)
                if req is not None:
                    latencies.append(t + dt - req.arrival_t)
                    counts["completed"] += 1
                    answer(req, t + dt)
        # 5. router-side timeouts: abandon the attempt, retry elsewhere
        #    (the zombie copy keeps grinding — its late completion is
        #    discarded by the ledger, never double-answered)
        for rid, (name, deadline) in list(outstanding.items()):
            if deadline <= t:
                del outstanding[rid]
                req = live.get(rid)
                if req is not None:
                    req.tried.add(name)
                    fail_attempt(req, t)
        # 6. SLO-burn hysteresis on fleet backlog
        backlog = sum(rep.backlog() for rep in fleet.values())
        if not slo["firing"] and backlog > sc.slo_fire_backlog \
                * total_slots:
            slo["firing"] = True
            slo["flaps"] += 1
        elif slo["firing"] and backlog < sc.slo_resolve_backlog \
                * total_slots:
            slo["firing"] = False
        # 7. canary evaluation on its own cadence (the controller's
        #    rollback path drains through _drain_cb -> replay, so a
        #    rollback's in-flight work re-enters placement this tick)
        if controller is not None and controller.state == "canary" \
                and t >= rollout["next_eval"]:
            rollout["next_eval"] = t + sc.rollout_eval_s
            controller.evaluate(now=t)

    t_wall0 = time.perf_counter()
    for _ in range(sc.n_ticks()):
        t = clock.now()
        step(t, sc.tick_s, arrivals=t < arrival_stop)
        clock.advance(sc.tick_s)
    drainout = 0
    while live and drainout < int(max_drainout_ticks):
        drainout += 1
        step(clock.now(), sc.tick_s, arrivals=False)
        clock.advance(sc.tick_s)
    wall_s = time.perf_counter() - t_wall0

    lost = len(live)                       # never answered = dropped
    duplicates = sum(1 for n in answers.values() if n > 1)
    amplification = ((counts["backend_attempts"]
                      - counts["handoff_replays"])
                     / max(1, counts["requests"]))
    observed = {
        "requests": counts["requests"],
        "completed": counts["completed"],
        "shed": counts["shed"],
        "lost": lost,
        "duplicates": duplicates,
        "retries": counts["retries"],
        "backend_attempts": counts["backend_attempts"],
        "handoff_replays": counts["handoff_replays"],
        "drains": counts["drains"],
        "late_discarded": counts["late_discarded"],
        "amplification": amplification,
        "budget": budget.stats(),
        "ledger": ledger.stats(),
        "slo_flaps": slo["flaps"],
        "slo_firing_at_end": slo["firing"],
    }
    rollout_obs = None
    if controller is not None:
        rollout_obs = {
            "rollbacks": len(controller.rollbacks),
            "rollback_episodes": list(controller.rollbacks),
            "promotions": list(controller.promotions),
            "versions_at_end": {n: fleet[n].version
                                for n in sorted(fleet)},
            "corrupt_rejected": rollout["corrupt_rejected"],
            "corrupt_loaded": rollout["corrupt_loaded"],
            "refused_offers": rollout["refused_offers"],
            "rollout_state": controller.state,
            "incumbent": controller.incumbent,
        }
        observed.update(rollout_obs)
    invariants = check_serve_scenario(observed, sc.expect)
    # invariant postmortem: when tracing is on and a conservation
    # invariant broke, dump the buffered hop traces of the offending
    # requests right into the verdict (lost = still live, never
    # answered; duplicated = answered more than once)
    offending: List[dict] = []
    if col.enabled and not all(r.ok for r in invariants):
        for rid in sorted(live)[:8]:
            offending.append({
                "request": rid, "state": "lost",
                "spans": col.peek(ctxs.get(rid))})
        for rid, n in sorted(answers.items()):
            if n > 1 and len(offending) < 24:
                entry = col.find(rid)
                offending.append({
                    "request": rid, "state": "duplicate", "answers": n,
                    "spans": (entry or {}).get("spans", [])})
    lat = sorted(latencies)

    def pct(p):
        return (round(lat[min(len(lat) - 1,
                              int(p * (len(lat) - 1)))], 4)
                if lat else None)

    result = ServeScenarioResult(
        name=sc.name,
        ok=all(r.ok for r in invariants),
        replicas=sc.replicas,
        ticks=sc.n_ticks() + drainout,
        duration_s=sc.duration_s,
        wall_s=round(wall_s, 3),
        requests=counts["requests"],
        completed=counts["completed"],
        shed=counts["shed"],
        lost=lost,
        duplicates=duplicates,
        retries=counts["retries"],
        backend_attempts=counts["backend_attempts"],
        handoff_replays=counts["handoff_replays"],
        drains=counts["drains"],
        late_discarded=counts["late_discarded"],
        amplification=round(amplification, 4),
        affinity_hits=placement.affinity_hits,
        slo_flaps=slo["flaps"],
        slo_firing_at_end=slo["firing"],
        p50_latency_s=pct(0.50),
        p99_latency_s=pct(0.99),
        budget=budget.stats(),
        invariants=invariants,
        offending_traces=offending,
        rollout=rollout_obs,
    )
    from bigdl_tpu_torch import obs

    obs.get_tracer().event(
        spans.EVENT_SCENARIO, scenario=result.name, ok=result.ok,
        replicas=result.replicas, requests=result.requests,
        completed=result.completed, shed=result.shed, lost=result.lost,
        duplicates=result.duplicates, retries=result.retries,
        handoff_replays=result.handoff_replays,
        amplification=result.amplification, wall_s=result.wall_s,
        invariants={r.name: r.ok for r in result.invariants})
    return result


__all__ = ["SERVE_SCENARIOS", "ServeScenario", "ServeScenarioResult",
           "SimServeReplica", "load_serve_scenario",
           "run_serve_scenario"]
